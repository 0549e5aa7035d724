"""Mean host time of one readback over the window's readbacks (one an
output token step): the program's ``step.readback`` span
(``ServingEngine._greedy``: the argmax and its copy to the host, where
the host waits on the device), in milliseconds. Nothing without the
program's spans."""


def read(run):
    spans = run.window_spans("step.readback") if getattr(run, "spans", None) is not None else []
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e6 if spans else None
