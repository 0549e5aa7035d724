"""Of the traced batch's device idle time, the share lying inside
``step.launch`` spans (the device idle while the host enqueues the same
step, against idle after the readback, in the bookkeeping or between
batches), in percent. Nothing without the program's spans."""
from portbench.spans import idle_intervals, spans_between


def read(run):
    t = run.trace
    if t is None or getattr(t, "spans", None) is None:
        return None
    launches = [(s.start_ns, s.end_ns) for s in spans_between(t) if s.name == "step.launch"]
    idle = idle_intervals(t)
    total = sum(b - a for a, b in idle)
    if not launches or not total:
        return None
    inside, k = 0, 0
    for a, b in idle:                           # both sorted, the launches disjoint
        while k < len(launches) and launches[k][1] <= a:
            k += 1
        j = k
        while j < len(launches) and launches[j][0] < b:
            inside += min(b, launches[j][1]) - max(a, launches[j][0])
            j += 1
    return 100.0 * inside / total
