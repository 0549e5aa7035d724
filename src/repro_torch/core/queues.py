"""Multilevel feedback queue management (paper §VI, §VII, §X).

Four queues Q1..Q4 partition the priority interval (−1, 1). On each
arrival every queued job is re-prioritized (``priority.reprioritize_np``,
the host float64 twin, as in the reference) and re-bucketed — jobs move
between queues in both directions, the paper's anti-starvation
mechanism. Within equal priority the order is FCFS by arrival; batches
are SJF-arranged (fewer processors first) before enqueue. Dispatch is
non-preemptive.

Congestion (§X): (arrival_rate − service_rate)/arrival_rate > Thrs.
"""
from __future__ import annotations

import itertools
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from . import priority as prio

__all__ = ["Job", "MultilevelFeedbackQueues", "is_congested"]

_seq = itertools.count()


@dataclass
class Job:
    """One schedulable unit — a subjob, or a whole group treated as one
    job by the meta-scheduler (§VIII)."""

    user: str
    t: float = 1.0                   # processors required (SJF key, §VII)
    submit_time: float = 0.0
    compute_work: float = 1.0        # processor·hours or FLOPs
    input_bytes: float = 0.0
    output_bytes: float = 0.0
    executable_bytes: float = 0.0
    group_id: Optional[str] = None
    job_id: int = field(default_factory=lambda: next(_seq))
    priority: float = 0.0
    queue: int = 1
    migrated: bool = False           # §IX: pinned after one migration
    site: Optional[str] = None

    @property
    def data_intensive(self) -> bool:
        return self.total_bytes > self.compute_work

    @property
    def total_bytes(self) -> float:
        return self.input_bytes + self.output_bytes + self.executable_bytes


def is_congested(arrival_rate: float, service_rate: float, thrs: float) -> bool:
    """Paper §X: (Arrival − Service)/Arrival > Thrs, Thrs ∈ (0, 1)."""
    if arrival_rate <= 0:
        return False
    return (arrival_rate - service_rate) / arrival_rate > thrs


class MultilevelFeedbackQueues:
    """The per-site DIANA queue manager: the four priority-band queues
    plus the per-user quota table §X re-prioritization needs."""

    def __init__(self, quotas: dict[str, float], congestion_thrs: float = 0.5):
        self.quotas = dict(quotas)
        self.congestion_thrs = congestion_thrs
        self.jobs: list[Job] = []          # all queued (not running) jobs
        self._arrivals = 0
        self._services = 0
        self._arrival_times: list[float] = []
        self._service_times: list[float] = []
        # Rate samples arrive in non-decreasing simulation time, so the
        # ones older than the widest window ever queried can be dropped
        # (see rates()); an out-of-order append disables the pruning.
        self._rate_monotone = True
        self._max_window = 0.0
        self._prune_floor = -float("inf")

    # -- §X quota aggregates ------------------------------------------------
    def _totals(self) -> tuple[float, float]:
        users = {j.user for j in self.jobs}
        Q = sum(self.quotas.get(u, 1.0) for u in users)
        T = sum(j.t for j in self.jobs)
        return Q, T

    def _user_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for j in self.jobs:
            counts[j.user] = counts.get(j.user, 0) + 1
        return counts

    # -- arrivals -----------------------------------------------------------
    def submit(self, job: Job, now: Optional[float] = None) -> Job:
        """Enqueue one job and §X-reprioritize everything."""
        if job.user not in self.quotas:
            self.quotas[job.user] = 1.0
        self.jobs.append(job)
        self._arrivals += 1
        t = job.submit_time if now is None else now
        if self._arrival_times and t < self._arrival_times[-1]:
            self._rate_monotone = False
        self._arrival_times.append(t)
        self.reprioritize_all()
        return job

    def submit_batch(self, jobs: Iterable[Job], now: Optional[float] = None) -> list[Job]:
        """SJF-arrange (§VII: fewer processors first) then enqueue."""
        batch = sorted(jobs, key=lambda j: (j.t, j.submit_time, j.job_id))
        return [self.submit(j, now) for j in batch]

    def reprioritize_all(self) -> None:
        """Recompute Pr for every queued job with current (Q, T) (§X)."""
        if not self.jobs:
            return
        Q, T = self._totals()
        counts = self._user_counts()
        n = np.array([counts[j.user] for j in self.jobs], np.float32)
        q = np.array([self.quotas[j.user] for j in self.jobs], np.float32)
        t = np.array([j.t for j in self.jobs], np.float32)
        pr, qidx = prio.reprioritize_np(n, q, t, Q, T)
        for j, p, qi in zip(self.jobs, pr, qidx):
            j.priority = float(p)
            j.queue = int(qi)

    # -- service ------------------------------------------------------------
    def pop_next(self, now: Optional[float] = None) -> Optional[Job]:
        """Dispatch the head job: highest priority; FCFS on ties (§X).
        Service does NOT trigger re-prioritization."""
        if not self.jobs:
            return None
        best = min(self.jobs, key=lambda j: (-j.priority, j.submit_time, j.job_id))
        self.jobs.remove(best)
        self._services += 1
        if now is not None:
            if self._service_times and now < self._service_times[-1]:
                self._rate_monotone = False
            self._service_times.append(now)
        return best

    def remove(self, job: Job) -> None:
        self.jobs.remove(job)

    # -- introspection --------------------------------------------------------
    def queue_contents(self) -> list[list[Job]]:
        """Jobs per band, each band sorted (priority desc, FCFS ties)."""
        bands: list[list[Job]] = [[] for _ in range(prio.NUM_QUEUES)]
        for j in self.jobs:
            bands[j.queue].append(j)
        for band in bands:
            band.sort(key=lambda j: (-j.priority, j.submit_time, j.job_id))
        return bands

    def __len__(self) -> int:
        return len(self.jobs)

    def jobs_ahead(self, p: float) -> int:
        """§IX: number of queued jobs with priority ≥ p."""
        return sum(1 for j in self.jobs if j.priority >= p)

    def low_priority_jobs(self) -> list[Job]:
        """§X: only low-priority (Q4) jobs are migration candidates."""
        return [j for j in self.jobs if j.queue == prio.NUM_QUEUES - 1]

    # -- rates / congestion ---------------------------------------------------
    def prune_rate_samples(self, cutoff: float) -> None:
        """Discard rate samples strictly older than ``cutoff`` (only while
        the recorded timestamps are non-decreasing)."""
        if not self._rate_monotone or cutoff <= self._prune_floor:
            return
        self._prune_floor = cutoff
        for lst in (self._arrival_times, self._service_times):
            i = bisect_left(lst, cutoff)
            if i:
                del lst[:i]

    def rates(self, window: float, now: float) -> tuple[float, float]:
        """(arrival_rate, service_rate) over the trailing window; ``now``
        is assumed non-decreasing across calls (the simulator's clock)."""
        lo = now - window
        if self._rate_monotone:
            if window > self._max_window:
                self._max_window = window
            self.prune_rate_samples(now - self._max_window)
            at, st = self._arrival_times, self._service_times
            arr = len(at) - bisect_left(at, lo)
            srv = len(st) - bisect_left(st, lo)
        else:
            arr = sum(1 for ts in self._arrival_times if ts >= lo)
            srv = sum(1 for ts in self._service_times if ts >= lo)
        return arr / window, srv / window

    def congested(self, window: float, now: float) -> bool:
        a, s = self.rates(window, now)
        return is_congested(a, s, self.congestion_thrs)

    def littles_law_estimate(self, window: float, now: float, avg_wait: float) -> float:
        """N = R·W (§VII)."""
        a, _ = self.rates(window, now)
        return prio.littles_law_queue_length(a, avg_wait)
