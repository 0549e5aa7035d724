"""The program's own spans, counters and marks (``repro_torch.tracing``)
beside the device trace: what the span readers are handed, and the
``idle_by_span`` breakdown.

A run with the program's tracing on (``spanrun.py``) turns it on for the
window and the profiled batch, and hands the readers a ``SpanView``: the
harness's ``View`` with

- ``spans``: ``tracing.collect()`` at the window's close, and ``anchor``,
  the spans' clock and ``time.perf_counter()`` read together, which maps
  a span onto the window's clock;
- ``trace``: a ``Trace`` from ``profile_call``, which profiles the batch
  as ``devtrace.profile_call`` does (device activity only) and keeps
  what that drops: the host's CUDA runtime and driver calls, which the
  profiler records with the device activity, the batch's ends on the
  spans' clock, and the spans again after the batch.

The spans' clock is the device trace's (``repro_torch.tracing``), so a
runtime call or a device gap is laid against the spans by its times.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

from .devtrace import Trace as DeviceTrace
from .devtrace import _short
from .view import View

__all__ = ["OUTSIDE", "SpanView", "Trace", "profile_call", "is_sync", "spans_between", "count_inside",
           "idle_intervals", "idle_by_span", "launch_coverage"]

# host calls that wait for the device: synchronize, and a copy without Async
_SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cuStreamSynchronize",
         "cuCtxSynchronize", "cuEventSynchronize")
_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")
OUTSIDE = "outside any span"


def is_sync(name: str) -> bool:
    return name.startswith(_SYNC) or (name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" not in name)


def is_launch(name: str) -> bool:
    return name.startswith(_LAUNCH)


@dataclass
class Trace(DeviceTrace):
    runtime: list = field(default_factory=list)    # (name, start ns, duration ns): host CUDA runtime/driver calls
    t0_ns: int = 0                                  # the profiled call's ends on the spans' clock
    t1_ns: int = 0
    spans: object = None                            # tracing.collect() after the batch


@dataclass
class SpanView(View):
    spans: object = None            # repro_torch.tracing.Recording at the window's close, or None
    anchor: tuple = (0, 0.0)        # (spans' clock ns, time.perf_counter()) read together

    def window_time(self, ns: int) -> float:
        """A time on the spans' clock on the window's clock (seconds after it opened, on the traffic's clock)."""
        a_ns, a_perf = self.anchor
        return (ns - a_ns) / 1e9 + a_perf - (self.record.open_wall - self.record.open_t)

    def window_spans(self, name: str) -> list:
        """The spans named ``name`` that started inside the window."""
        return [s for s in self.spans.named(name) if self.record.open_t <= self.window_time(s.start_ns) <= self.close_t]


def profile_call(torch, fn, clock_ns, top_gaps: int = 10) -> Trace:
    """Run ``fn`` under the profiler (device activity only) and reduce its
    trace as ``devtrace.profile_call`` does; keep the host's runtime calls
    and the call's ends on ``clock_ns``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0, ns0 = time.perf_counter(), clock_ns()
        fn()
        torch.cuda.synchronize()
        window, ns1 = time.perf_counter() - t0, clock_ns()
    events = prof.profiler.kineto_results.events()
    kernels, runtime = [], []
    for e in events:
        if e.is_user_annotation():
            continue
        (kernels if e.device_type() == DeviceType.CUDA else runtime).append((e.name(), e.start_ns(), e.duration_ns()))
    kernels.sort(key=lambda k: k[1])
    runtime.sort(key=lambda k: k[1])
    merged = _merge(kernels)
    busy = sum(e - s for s, e, _, _ in merged)
    idle = sorted(((b[0] - a[1], f"after {_short(a[3])} / before {_short(b[2])}")
                   for a, b in zip(merged, merged[1:])), reverse=True)[:top_gaps]
    return Trace(window_s=window, busy_s=busy / 1e9, kernels=kernels,
                 gaps=[(label, length / 1e9) for length, label in idle], runtime=runtime, t0_ns=ns0, t1_ns=ns1)


def _merge(kernels) -> list[list]:
    """The union of the device operations' intervals: [start, end, first op, last op]."""
    merged: list[list] = []
    for name, s, d in kernels:
        if merged and s <= merged[-1][1]:
            if s + d > merged[-1][1]:
                merged[-1][1], merged[-1][3] = s + d, name
        else:
            merged.append([s, s + d, name, name])
    return merged


def spans_between(trace: Trace) -> list:
    """The spans that started inside the profiled call, in the order they opened."""
    spans = trace.spans.spans if trace.spans is not None else []
    return [s for s in spans if trace.t0_ns <= s.start_ns <= trace.t1_ns]


def count_inside(spans: list, times) -> int:
    """How many of ``times`` lie inside one of ``spans`` (disjoint, in time order)."""
    starts = [s.start_ns for s in spans]
    n = 0
    for t in times:
        k = bisect.bisect_right(starts, t) - 1
        n += k >= 0 and t <= spans[k].end_ns
    return n


def idle_intervals(trace: Trace) -> list[tuple[int, int]]:
    """The device's idle intervals over the profiled call, ns: before the
    first operation, between operations and after the last."""
    merged = _merge(trace.kernels)
    edges = [trace.t0_ns] + [x for s, e, _, _ in merged for x in (s, e)] + [trace.t1_ns]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def innermost(spans) -> tuple[list[int], list[int]]:
    """The program's timeline as (times, owner): from ``times[i]`` to
    ``times[i + 1]`` the innermost open span is ``spans[owner[i]]`` (−1:
    none). ``spans`` nest; those that hold no time are left out."""
    edges = sorted([(s.start_ns, 1, i) for i, s in enumerate(spans) if s.end_ns and s.end_ns > s.start_ns]
                   + [(s.end_ns, 0, i) for i, s in enumerate(spans) if s.end_ns and s.end_ns > s.start_ns])
    times, owner, stack = [], [], []
    for t, opening, i in edges:
        if opening:
            stack.append(i)
        else:
            stack.remove(i)
        times.append(t)
        owner.append(stack[-1] if stack else -1)
    return times, owner


def _owner(times: list[int], owner: list[int], t: int) -> int:
    k = bisect.bisect_right(times, t) - 1
    return owner[k] if k >= 0 else -1


def idle_by_span(trace: Trace, top: int = 10) -> dict:
    """Device idle seconds and sync calls of the profiled call by the
    innermost program span holding them (an idle interval split where the
    innermost span changes), the ``top`` largest by idle time and those
    outside any span; with the share of the idle time inside some span."""
    spans = spans_between(trace)
    times, owner = innermost(spans)
    name = lambda o: spans[o].name if o >= 0 else OUTSIDE      # noqa: E731
    idle: dict[str, float] = {}
    syncs: dict[str, int] = {}
    for a, b in idle_intervals(trace):
        k, t = bisect.bisect_right(times, a) - 1, a
        while t < b:
            end = min(times[k + 1], b) if k + 1 < len(times) else b
            key = name(owner[k] if k >= 0 else -1)
            idle[key] = idle.get(key, 0.0) + (end - t) / 1e9
            t, k = end, k + 1
    for call, s, _ in trace.runtime:
        if is_sync(call):
            key = name(_owner(times, owner, s))
            syncs[key] = syncs.get(key, 0) + 1
    total = sum(idle.values())
    inside = sorted((idle.keys() | syncs.keys()) - {OUTSIDE}, key=lambda k: (-idle.get(k, 0.0), -syncs.get(k, 0)))[:top]
    return {"idle_s": total, "in_spans_share": 1.0 - idle.get(OUTSIDE, 0.0) / total if total else None,
            "by_span": [[k, idle.get(k, 0.0), syncs.get(k, 0)] for k in inside]
            + [[OUTSIDE, idle.get(OUTSIDE, 0.0), syncs.get(OUTSIDE, 0)]]}


def launch_coverage(trace: Trace) -> dict:
    """Of the profiled call's kernel launches (host runtime calls), the share
    whose start lies inside a ``step.launch`` or a ``step.readback`` span."""
    spans = [s for s in spans_between(trace) if s.name in ("step.launch", "step.readback")]
    launches = [at for name, at, _ in trace.runtime if is_launch(name)]
    return {"launches": len(launches),
            "inside_share": count_inside(spans, launches) / len(launches) if launches else None}
