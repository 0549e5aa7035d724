"""The whole step's share of the chip's bf16 peak: the model FLOPs of
every token the window's batches processed in a lane that carried a
request (``counts``: twice the active parameters a token passes through,
plus attention over its keys), over the window's length and the peak,
in percent."""
from portbench import counts


def read(run):
    flops = sum(x.served * run.lane_flops(x.steps) for x in run.batches)
    return 100.0 * flops / run.window_s / counts.PEAKS["bf16_flops_per_s"] if run.batches else None
