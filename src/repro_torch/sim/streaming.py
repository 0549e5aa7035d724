"""Open-loop streaming support for the grid simulator.

``ArrivalSource`` is the lazy job-stream protocol the event-horizon
run loop consumes: anything with a ``chunks()`` method yielding lists
of ``SimJob``s in non-decreasing ``arrival`` order. Chunk boundaries
are invisible to the simulator (``_ArrivalCursor`` re-buffers across
them), so a source is free to generate 1-job or 100k-job chunks — the
placements are identical either way (property-tested).

``StreamStats`` is the bounded per-run accumulator that replaces the
retained per-job record list in streaming mode: exact counters, means
and extrema plus log-binned histogram quantiles (``StreamingQuantiles``,
~1% relative error) for queue time, execution time and turnaround —
O(bins) memory however many jobs stream through.

Plain Python and NumPy, carried over from the reference's
``sim/streaming.py``.
"""
from __future__ import annotations

from bisect import bisect_left
from collections import deque
from dataclasses import dataclass, field
from math import ceil, inf
from typing import TYPE_CHECKING, Iterator, Protocol, Sequence, runtime_checkable

import numpy as np

if TYPE_CHECKING:  # avoid a runtime cycle: workloads imports ChunkSource
    from .workloads import SimJob

__all__ = [
    "ArrivalSource",
    "ChunkSource",
    "as_arrival_source",
    "StreamingQuantiles",
    "StreamStats",
]


@runtime_checkable
class ArrivalSource(Protocol):
    """A lazy stream of timestamped jobs for ``GridSim.run``."""

    def chunks(self) -> Iterator[Sequence["SimJob"]]:
        """Yield job chunks in non-decreasing ``arrival`` order (both
        within and across chunks). Each call starts a fresh stream."""
        ...


class ChunkSource:
    """``ArrivalSource`` over a zero-argument chunk-iterator factory —
    the adapter generator workloads return (``poisson_source``,
    ``serving_trace_source``). Re-iterable: each ``chunks()`` call
    invokes the factory again."""

    def __init__(self, make_chunks):
        self._make_chunks = make_chunks

    def chunks(self):
        return self._make_chunks()


def as_arrival_source(jobs) -> ArrivalSource:
    """Coerce ``run()`` input into an ``ArrivalSource``: conforming
    objects pass through; a plain job sequence becomes a one-shot
    source whose single chunk is stable-sorted by arrival (exactly the
    order the per-event heap would pop it in)."""
    if hasattr(jobs, "chunks"):
        return jobs
    if isinstance(jobs, (list, tuple)):
        items = list(jobs)
        return ChunkSource(
            lambda: iter([sorted(items, key=lambda j: j.arrival)])
        )
    raise TypeError(
        f"run() expects a list of SimJob or an ArrivalSource "
        f"(object with .chunks()), got {type(jobs).__name__}"
    )


class _ArrivalCursor:
    """Pull-based view of an ``ArrivalSource`` for the horizon loop.

    ``peek_time()`` is the next arrival timestamp (``inf`` when
    drained); ``pop_until(t)`` removes and returns every job with
    ``arrival <= t``. Chunks are fetched on demand and the protocol's
    ordering contract is enforced: a job arriving earlier than one
    already delivered raises ``ValueError``.
    """

    def __init__(self, chunk_iter):
        self._iter = iter(chunk_iter)
        self._buf: deque = deque()
        self._exhausted = False
        self._last = -inf

    def _fill(self) -> None:
        while not self._buf and not self._exhausted:
            try:
                chunk = next(self._iter)
            except StopIteration:
                self._exhausted = True
                return
            last = self._last
            for sj in chunk:
                if sj.arrival < last:
                    raise ValueError(
                        f"ArrivalSource yielded out-of-order job: arrival "
                        f"{sj.arrival} after {last} (chunks must be "
                        f"non-decreasing in arrival time)"
                    )
                last = sj.arrival
            self._last = last
            self._buf.extend(chunk)

    def peek_time(self) -> float:
        self._fill()
        return self._buf[0].arrival if self._buf else inf

    def pop_until(self, t_hi: float) -> list:
        out = []
        while True:
            self._fill()
            if not self._buf or self._buf[0].arrival > t_hi:
                return out
            out.append(self._buf.popleft())

    def drain(self) -> list:
        """Materialize the remainder (the per-event reference loop
        needs the full list up front to seed its heap)."""
        return self.pop_until(inf)


class StreamingQuantiles:
    """Bounded-memory quantile sketch over non-negative values.

    Deterministic log-binned histogram: ``bins`` geometric buckets
    between ``lo`` and ``hi`` plus an exact-zero/underflow bucket and
    an overflow bucket. Quantiles are read back as the geometric
    midpoint of the selected bucket (&le; ~1.4% relative error at the
    default resolution), with exact min/max/mean tracked on the side.
    Queue times are frequently exactly 0 — the underflow bucket reports
    them as 0.0 instead of smearing them into the lowest bin.
    """

    __slots__ = ("lo", "hi", "edges", "counts", "n", "total", "vmin", "vmax")

    def __init__(self, lo: float = 1e-3, hi: float = 1e9, bins: int = 1024):
        self.lo = float(lo)
        self.hi = float(hi)
        self.edges = np.geomspace(lo, hi, bins + 1).tolist()
        self.counts = [0] * (bins + 2)   # [underflow, bins..., overflow]
        self.n = 0
        self.total = 0.0
        self.vmin = inf
        self.vmax = -inf

    def add(self, x: float) -> None:
        x = float(x)
        self.n += 1
        self.total += x
        if x < self.vmin:
            self.vmin = x
        if x > self.vmax:
            self.vmax = x
        if x <= self.lo:
            self.counts[0] += 1
        elif x > self.hi:
            self.counts[-1] += 1
        else:
            self.counts[bisect_left(self.edges, x)] += 1

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0 <= q <= 1) of the added values."""
        if self.n == 0:
            return 0.0
        if q <= 0.0:
            return self.vmin
        rank = min(self.n, max(1, ceil(q * self.n)))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                if i == 0:
                    return max(0.0, self.vmin)
                if i == len(self.counts) - 1:
                    return self.vmax
                return float(np.sqrt(self.edges[i - 1] * self.edges[i]))
        return self.vmax

    def summary(self, qs: Sequence[float] = (0.5, 0.95, 0.99)) -> dict:
        out = {"n": self.n, "mean": self.mean,
               "min": self.vmin if self.n else 0.0,
               "max": self.vmax if self.n else 0.0}
        for q in qs:
            out[f"p{int(round(q * 100)):02d}"] = self.quantile(q)
        return out


@dataclass
class StreamStats:
    """Streaming-safe per-run accumulators (always populated by
    ``GridSim.run``; the only per-job record in open-loop streaming
    mode). Histogram adds happen in job-finish order, so two
    bit-identical simulations produce equal ``StreamStats``."""

    admitted: int = 0
    finished: int = 0
    migrated: int = 0
    peak_in_flight: int = 0
    #: Fault-injection counters (``SimConfig.fault_plan``): jobs
    #: displaced from a site that went down (killed mid-run or drained
    #: from its queue) and re-placed via the §IX migration path, and
    #: stale-view submissions that aimed at an authoritatively-dead
    #: site and were redirected at admission. Both are events, not
    #: terminal states — a requeued/redirected job still finishes, so
    #: conservation reads admitted = finished + in-flight throughout.
    requeued: int = 0
    redirected: int = 0
    first_arrival: float = inf
    last_finish: float = 0.0
    queue_times: StreamingQuantiles = field(default_factory=StreamingQuantiles)
    exec_times: StreamingQuantiles = field(default_factory=StreamingQuantiles)
    turnarounds: StreamingQuantiles = field(default_factory=StreamingQuantiles)

    def on_admit(self, sj, in_flight: int) -> None:
        self.admitted += 1
        if in_flight > self.peak_in_flight:
            self.peak_in_flight = in_flight
        if sj.arrival < self.first_arrival:
            self.first_arrival = sj.arrival

    def on_requeue(self) -> None:
        self.requeued += 1

    def on_redirect(self) -> None:
        self.redirected += 1

    def on_finish(self, sj) -> None:
        self.finished += 1
        if sj.migrated:
            self.migrated += 1
        if sj.finish > self.last_finish:
            self.last_finish = sj.finish
        self.queue_times.add(sj.queue_time)
        self.exec_times.add(sj.exec_time)
        self.turnarounds.add(sj.turnaround)

    def __eq__(self, other) -> bool:
        if not isinstance(other, StreamStats):
            return NotImplemented
        return (
            (self.admitted, self.finished, self.migrated, self.peak_in_flight,
             self.requeued, self.redirected,
             self.first_arrival, self.last_finish)
            == (other.admitted, other.finished, other.migrated,
                other.peak_in_flight, other.requeued, other.redirected,
                other.first_arrival, other.last_finish)
            and all(
                getattr(self, f).counts == getattr(other, f).counts
                and getattr(self, f).total == getattr(other, f).total
                for f in ("queue_times", "exec_times", "turnarounds")
            )
        )
