"""One engine batch under ``torch.profiler``, reduced to what the readers need.

Only the device's activity is recorded (``ProfilerActivity.CUDA``):
recording every host operator as well slowed a batch by three quarters
on the card, which would be read as idle time. The raw Kineto events are
read (``kineto_results.events()``), not ``key_averages()``, which turns a
long trace's events into Python objects for minutes (the copy of
``chip_smoke.py``'s migration-tick trace). The traced window is the host
clock around the call, which ends in a synchronize. From the trace:

- ``kernels``: every device operation (kernels, copies, sets): name,
  start ns, duration ns;
- ``busy_s``: the union of their intervals;
- ``gaps``: the idle intervals between them, the longest first, each
  labelled by the operation that ended before it and the one that began
  after it (the host's work in between: launching, a readback, Python).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["Trace", "profile_call"]


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list[tuple[str, int, int]]          # (name, start ns, duration ns)
    gaps: list[tuple[str, float]]                 # (label, seconds), longest first
    steps: list[int] = field(default_factory=list)   # the positions the traced batch stepped through
    lanes: int = 0

    def device_ops(self, top: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for name, _, dur in self.kernels:
            by[name] = by.get(name, 0.0) + dur / 1e9
        return [[n[:160], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def kernel_seconds(self, *symbols: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose names hold one of ``symbols``."""
        hit = [d for n, _, d in self.kernels if any(s in n for s in symbols)]
        return sum(hit) / 1e9, len(hit)


def _short(name: str) -> str:
    return name.split("(")[0].replace("void ", "")[:70]


def profile_call(torch, fn, top_gaps: int = 10) -> Trace:
    """Run ``fn`` under the profiler (device activity only) and reduce its trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    kernels = sorted(((e.name(), e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()), key=lambda k: k[1])
    merged: list[list] = []                       # [start, end, name of the first op, name of the last op]
    for name, s, d in kernels:
        if merged and s <= merged[-1][1]:
            if s + d > merged[-1][1]:
                merged[-1][1], merged[-1][3] = s + d, name
        else:
            merged.append([s, s + d, name, name])
    busy = sum(e - s for s, e, _, _ in merged)
    idle = sorted(((b[0] - a[1], f"after {_short(a[3])} / before {_short(b[2])}")
                   for a, b in zip(merged, merged[1:])), reverse=True)[:top_gaps]
    return Trace(window_s=window, busy_s=busy / 1e9, kernels=kernels,
                 gaps=[(label, length / 1e9) for length, label in idle])
