"""Mean host time of one lockstep step's launch over the window's steps:
the program's ``step.launch`` span (``ServingEngine._step``: the tokens to
the device and the ``decode_step`` call, which returns once its kernels
are enqueued), in milliseconds. Nothing without the program's spans."""


def read(run):
    spans = run.window_spans("step.launch") if getattr(run, "spans", None) is not None else []
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e6 if spans else None
