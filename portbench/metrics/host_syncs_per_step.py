"""Host calls that wait for the device (stream, device or event
synchronize; a copy without Async) whose start lies inside a
``step.launch`` span, per lockstep step of the traced batch: the device
trace's CUDA runtime calls laid against the program's spans on their
shared clock. The readback's own wait lies in ``step.readback`` and is
not counted. Nothing without the program's spans and the runtime calls."""
from portbench.spans import count_inside, is_sync, spans_between


def read(run):
    t = run.trace
    if t is None or not getattr(t, "runtime", None) or getattr(t, "spans", None) is None:
        return None
    launches = [s for s in spans_between(t) if s.name == "step.launch"]
    syncs = [at for name, at, _ in t.runtime if is_sync(name)]
    return count_inside(launches, syncs) / len(launches) if launches else None
