"""One minus the union of the device's operations over the traced batch
(one whole batch in steady state, under ``torch.profiler``), in percent."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t is not None and t.window_s > 0 else None
