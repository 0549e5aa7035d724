"""Workload generators for the grid simulator.

Includes the paper's test-grid shape (§XI: five sites — site 1 with
four nodes, the rest with five) and a scaled CMS analysis workload from
the §II estimates (jobs/day, dataset sizes, subjob fan-out).

Every generator returns an ``ArrivalSource``-conforming value:
``bulk_burst``/``poisson_stream``/``cms_case_study`` return a
``JobList`` (a real ``list`` that also yields itself as one sorted
chunk), while ``poisson_source`` and ``serving_trace_source`` are lazy
— they generate jobs chunk-by-chunk as the simulator consumes them, so
a million-job open-loop run never materializes the full list.

Carried over from the reference's ``sim/workloads.py``: the same
NumPy ``default_rng`` draws in the same order, so a seeded workload
here is the reference's jobs, value for value.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from .streaming import ChunkSource

__all__ = [
    "SimJob", "JobList", "paper_grid_spec",
    "bulk_burst", "poisson_stream", "poisson_source",
    "diurnal_source", "cms_case_study", "serving_trace_source",
]


@dataclass
class SimJob:
    user: str
    arrival: float
    work: float                      # pure execution seconds on one node
    input_bytes: float = 0.0
    output_bytes: float = 0.0
    data_site: Optional[str] = None  # where the input dataset lives
    origin_site: str = "site1"       # submission site (output returns here)
    t: float = 1.0                   # processors (SJF / priority key)
    group_id: Optional[str] = None
    # -- runtime bookkeeping (filled by the simulator) --
    exec_site: Optional[str] = None
    queue_enter: float = field(default=0.0)
    start: float = field(default=-1.0)
    finish: float = field(default=-1.0)
    migrated: bool = False
    #: Fault-injection bookkeeping: how many times this job was
    #: displaced (its site went down mid-run, or a stale-view placement
    #: bounced off an authoritatively-dead site) and re-placed.
    #: ``queue_enter`` keeps the *first* admission instant, so
    #: ``queue_time`` spans the whole displaced wait.
    requeues: int = 0

    @property
    def queue_time(self) -> float:
        return max(0.0, self.start - self.queue_enter)

    @property
    def exec_time(self) -> float:
        return max(0.0, self.finish - self.start)

    @property
    def turnaround(self) -> float:
        return max(0.0, self.finish - self.arrival)


class JobList(list):
    """A materialized job list that is also an ``ArrivalSource``: one
    chunk, stable-sorted by arrival (exactly the order the per-event
    heap pops equal-timestamp jobs in, so list and source entry points
    are bit-identical)."""

    def chunks(self):
        yield sorted(self, key=lambda j: j.arrival)


def paper_grid_spec() -> dict[str, int]:
    """§XI test grid: site1 has 4 nodes, site2..site5 have 5 each."""
    return {"site1": 4, "site2": 5, "site3": 5, "site4": 5, "site5": 5}


def bulk_burst(
    user: str,
    n: int,
    at: float = 0.0,
    work: float = 60.0,
    input_bytes: float = 1e9,
    output_bytes: float = 1e8,
    data_site: str = "site1",
    origin_site: str = "site1",
    group_id: Optional[str] = None,
    rng: Optional[np.random.Generator] = None,
    work_jitter: float = 0.0,
) -> JobList:
    """One bulk submission: n similar jobs at the same instant (§VIII:
    'the priority of the burst … is always the same since each batch of
    jobs has the same execution requirements')."""
    rng = rng or np.random.default_rng(0)
    jobs = JobList()
    for i in range(n):
        w = work * float(1.0 + (rng.uniform(-work_jitter, work_jitter) if work_jitter else 0.0))
        jobs.append(
            SimJob(
                user=user, arrival=at, work=w,
                input_bytes=input_bytes, output_bytes=output_bytes,
                data_site=data_site, origin_site=origin_site,
                group_id=group_id or f"{user}@{at:.0f}",
            )
        )
    return jobs


def poisson_source(
    user: str,
    rate_per_s: float,
    duration_s: float,
    seed: int = 0,
    chunk_jobs: int = 4096,
    **job_kw,
) -> ChunkSource:
    """Lazy Poisson arrival stream: jobs are drawn chunk-by-chunk as
    the simulator consumes them. Job-for-job identical to
    ``poisson_stream`` with the same seed (same RNG draw order)."""
    def _chunks():
        rng = np.random.default_rng(seed)
        t, buf = 0.0, []
        while True:
            t += float(rng.exponential(1.0 / rate_per_s))
            if t > duration_s:
                break
            buf.extend(bulk_burst(user, 1, at=t, rng=rng, **job_kw))
            if len(buf) >= chunk_jobs:
                yield buf
                buf = []
        if buf:
            yield buf
    return ChunkSource(_chunks)


def diurnal_source(
    user: str,
    base_rate_per_s: float,
    duration_s: float,
    amplitude: float = 0.8,
    period_s: float = 86_400.0,
    phase_s: float = 0.0,
    spikes: tuple = (),
    seed: int = 0,
    chunk_jobs: int = 4096,
    **job_kw,
) -> ChunkSource:
    """Lazy inhomogeneous-Poisson stream with a sinusoidal (diurnal)
    rate plus scripted flash-crowd spikes.

    The instantaneous rate is ``base * (1 + amplitude *
    sin(2π (t + phase) / period))`` (``0 <= amplitude < 1`` keeps it
    positive), sampled by Lewis–Shedler thinning against the peak rate
    — deterministic for a given seed, and chunk boundaries stay
    invisible to the simulator. ``spikes`` is a sequence of
    ``(at_s, n_jobs)`` flash crowds: ``n_jobs`` extra same-instant
    arrivals injected at ``at_s`` (a §VIII-style bulk burst riding the
    diurnal baseline), merged into the stream in arrival order.
    """
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    spike_list = sorted((float(at), int(n)) for at, n in spikes)
    if any(at > duration_s for at, _ in spike_list):
        raise ValueError("spike beyond duration_s")
    peak = base_rate_per_s * (1.0 + amplitude)

    def _rate(t: float) -> float:
        return base_rate_per_s * (
            1.0 + amplitude * np.sin(2.0 * np.pi * (t + phase_s) / period_s)
        )

    def _chunks():
        rng = np.random.default_rng(seed)
        pending = list(spike_list)
        t, buf = 0.0, []

        def flush_spikes(up_to: float):
            while pending and pending[0][0] <= up_to:
                at, n = pending.pop(0)
                for k in range(n):
                    buf.append(
                        SimJob(
                            user=user, arrival=at, work=60.0,
                            group_id=f"{user}-spike@{at:.0f}",
                            **{k2: v for k2, v in job_kw.items()},
                        )
                        if "work" not in job_kw
                        else SimJob(
                            user=user, arrival=at,
                            group_id=f"{user}-spike@{at:.0f}", **job_kw,
                        )
                    )

        while True:
            t += float(rng.exponential(1.0 / peak))
            if t > duration_s:
                break
            accept = float(rng.uniform()) < _rate(t) / peak
            flush_spikes(t if not accept else np.nextafter(t, 0.0))
            if accept:
                buf.append(SimJob(user=user, arrival=t, work=60.0, **job_kw)
                           if "work" not in job_kw
                           else SimJob(user=user, arrival=t, **job_kw))
            if len(buf) >= chunk_jobs:
                yield buf
                buf = []
        flush_spikes(duration_s)
        if buf:
            yield buf
    return ChunkSource(_chunks)


def poisson_stream(
    user: str,
    rate_per_s: float,
    duration_s: float,
    seed: int = 0,
    **job_kw,
) -> JobList:
    """Materialized ``poisson_source`` (kept for small workloads and
    for callers that index/slice the result)."""
    jobs = JobList()
    for chunk in poisson_source(user, rate_per_s, duration_s, seed, **job_kw).chunks():
        jobs.extend(chunk)
    return jobs


def cms_case_study(scale: float = 1.0, seed: int = 0) -> JobList:
    """§II estimates, scaled: 100 users, 250 jobs/day expected tier;
    dataset ~30 GB; runtime seconds→hours. ``scale`` shrinks the day."""
    rng = np.random.default_rng(seed)
    users = [f"phys{i:03d}" for i in range(max(2, int(100 * scale)))]
    n_jobs = max(10, int(250 * scale))
    day = 86_400.0 * scale
    jobs = JobList()
    for _ in range(n_jobs):
        user = users[int(rng.integers(len(users)))]
        arrival = float(rng.uniform(0, day))
        work = float(rng.lognormal(mean=4.0, sigma=1.5))      # ~55 s median
        data_gb = float(rng.lognormal(mean=2.5, sigma=1.0))   # ~12 GB median
        jobs.append(
            SimJob(
                user=user, arrival=arrival, work=work,
                input_bytes=data_gb * 1e9, output_bytes=data_gb * 1e7,
                data_site=f"site{int(rng.integers(1, 6))}",
                origin_site=f"site{int(rng.integers(1, 6))}",
            )
        )
    jobs.sort(key=lambda j: j.arrival)
    return jobs


def serving_trace_source(
    requests: Iterable,
    *,
    origin_site: str = "site1",
    data_site: Optional[str] = None,
    work_per_token: float = 0.05,
    output_bytes_per_token: float = 4.0,
    origin_of=None,
    chunk_jobs: int = 1024,
) -> ChunkSource:
    """Replay a ``serving/engine.py`` request trace through the grid
    scheduler as an open-loop ``ArrivalSource``.

    ``requests`` is any iterable of ``InferenceRequest``-shaped objects
    (duck-typed — only ``user``, ``prompt``, ``max_new_tokens``,
    ``submit_time`` and ``group_id`` are read, so traces can be replayed
    without importing the serving engine), ordered by
    ``submit_time``. Each request becomes one ``SimJob``: work scales
    with total tokens (prefill + decode), input bytes are the prompt
    bytes (the prefix-cache/data-locality term), output bytes the
    generated tokens. ``origin_of`` optionally maps a request to its
    submission site (e.g. a tenant→site routing table); otherwise all
    requests enter at ``origin_site``.
    """
    def _chunks():
        buf = []
        for r in requests:
            prompt = np.asarray(r.prompt)
            tokens = int(prompt.size) + int(r.max_new_tokens)
            buf.append(SimJob(
                user=r.user,
                arrival=float(r.submit_time),
                work=tokens * work_per_token,
                input_bytes=float(prompt.nbytes),
                output_bytes=float(r.max_new_tokens) * output_bytes_per_token,
                data_site=data_site,
                origin_site=origin_of(r) if origin_of is not None else origin_site,
                group_id=r.group_id,
            ))
            if len(buf) >= chunk_jobs:
                yield buf
                buf = []
        if buf:
            yield buf
    return ChunkSource(_chunks)
