"""The (token, choice) pairs the single-device MoE dispatch sent to its
drop bin (at or past the capacity C), over those it routed: the
program's device counters ``moe.dropped`` and ``moe.routed`` from
tracing's start to the window's close, in percent. Nothing where no MoE
layer ran or without the program's counters."""


def read(run):
    spans = getattr(run, "spans", None)
    routed = spans.counts.get("moe.routed", 0) if spans is not None else 0
    return 100.0 * spans.counts.get("moe.dropped", 0) / routed if routed else None
