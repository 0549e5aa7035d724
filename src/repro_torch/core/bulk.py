"""Bulk scheduling (paper §VIII).

A user's bulk submission is one **group** — a single atomic job to the
meta-scheduler. Placement:

  1. Can a single site accommodate the whole group, and is that
     cost-effective versus splitting?  If yes → submit the group there.
  2. Otherwise divide the group into subgroups using the division
     factor, place each subgroup, and aggregate all outputs to the
     user-specified location.

Groups never merge across users. ``allocate_proportional`` reproduces
the paper's Fig 4 worked example.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .queues import Job
from .scheduler import DianaScheduler, JobClass

__all__ = [
    "BulkGroup",
    "GroupPlacement",
    "allocate_proportional",
    "average_makespan",
    "BulkScheduler",
    "stable_user_peer",
    "submitting_peer",
    "route_groups",
]


@dataclass
class BulkGroup:
    """One bulk submission from one user (§VIII)."""

    user: str
    jobs: list[Job]
    group_id: str
    division_factor: int = 1          # VO-set number of subgroups when splitting
    output_location: str = "user"     # where results aggregate
    submit_site: Optional[str] = None  # where the submission enters the grid

    def __post_init__(self) -> None:
        for j in self.jobs:
            j.group_id = self.group_id
        if self.division_factor < 1:
            raise ValueError("division factor must be ≥ 1")

    @property
    def size(self) -> int:
        return len(self.jobs)

    @property
    def total_work(self) -> float:
        return sum(j.compute_work for j in self.jobs)

    @property
    def total_bytes(self) -> float:
        return sum(j.total_bytes for j in self.jobs)


@dataclass
class GroupPlacement:
    """Placement result: jobs per site + the aggregation plan."""

    group_id: str
    assignments: dict[str, list[Job]]
    output_location: str
    split: bool

    @property
    def sites(self) -> list[str]:
        return [s for s, js in self.assignments.items() if js]


def allocate_proportional(
    num_jobs: int, num_subgroups: int, capacities: dict[str, float]
) -> dict[str, int]:
    """Split ``num_jobs`` across the ``min(num_subgroups, #sites)`` most
    capable sites, proportionally to capacity (paper Fig 4 policy).

    Largest-remainder rounding keeps the total exact. Chosen sites with
    zero total capacity get an even split; no sites at all is a caller
    error.
    """
    if not capacities:
        raise ValueError("allocate_proportional: no sites to allocate across")
    k = min(num_subgroups, len(capacities))
    chosen = sorted(capacities.items(), key=lambda kv: -kv[1])[:k]
    total_cap = sum(c for _, c in chosen)
    if total_cap <= 0:
        raw = {name: num_jobs / len(chosen) for name, _ in chosen}
    else:
        raw = {name: num_jobs * cap / total_cap for name, cap in chosen}
    alloc = {name: int(math.floor(v)) for name, v in raw.items()}
    remainder = num_jobs - sum(alloc.values())
    # Largest fractional remainders get the leftover jobs.
    by_frac = sorted(raw, key=lambda name: raw[name] - alloc[name], reverse=True)
    for name in by_frac[:remainder]:
        alloc[name] += 1
    return alloc


def average_makespan(
    allocation: dict[str, int], capacities: dict[str, float], hours_per_job: float = 1.0
) -> float:
    """Fig 4 metric: mean over used sites of jobs_i/capacity_i·h."""
    spans = [n * hours_per_job / capacities[s] for s, n in allocation.items() if n > 0]
    return float(np.mean(spans)) if spans else 0.0


class BulkScheduler:
    """§VIII group placement on top of the §V DianaScheduler."""

    def __init__(self, diana: DianaScheduler, max_group_fraction: float = 1.0):
        self.diana = diana
        # A site "accommodates" a group if group work ≤ fraction of its
        # free capacity (the VO capacity-matching policy).
        self.max_group_fraction = max_group_fraction

    def _group_as_job(self, group: BulkGroup, jobs: Sequence[Job]) -> Job:
        """§VIII: each (sub)group is a single job to the meta-scheduler."""
        return Job(
            user=group.user,
            t=sum(j.t for j in jobs),
            compute_work=sum(j.compute_work for j in jobs),
            input_bytes=sum(j.input_bytes for j in jobs),
            output_bytes=sum(j.output_bytes for j in jobs),
            executable_bytes=sum(j.executable_bytes for j in jobs),
            group_id=group.group_id,
        )

    def _fits(self, site_name: str, jobs: Sequence[Job]) -> bool:
        site = self.diana.sites[site_name]
        need = sum(j.t for j in jobs)
        return need <= site.free_slots * self.max_group_fraction

    def schedule_group(self, group: BulkGroup) -> GroupPlacement:
        """The §VIII algorithm."""
        whole = self._group_as_job(group, group.jobs)
        decision = self.diana.select_site(whole)
        return self._place_group(group, decision.site)

    def schedule_groups(self, groups: Sequence[BulkGroup]) -> list[GroupPlacement]:
        """Batched §VIII: one (groups × sites) §IV pass on the scheduler's
        device. The static network/data-transfer planes are evaluated once;
        between groups only the computation term is re-derived from the
        live site state the per-group commits mutate, so results equal
        ``schedule_group`` on each group in order."""
        from . import batch as _batch

        if not groups:
            return []
        wholes = [self._group_as_job(g, g.jobs) for g in groups]
        dev = self.diana.device
        sp = _batch.SitePack.from_scheduler(self.diana.sites, self.diana.links, device=dev)
        jp = _batch.JobPack.from_jobs(wholes, device=dev)
        w = self.diana.weights
        net, _, dtc = _batch.cost_components(jp, sp, w)
        placements = []
        for g, group in enumerate(groups):
            sp.refresh_dynamic(self.diana.sites)
            cls = jp.classes[g]
            comp = None
            if cls is not JobClass.DATA:
                comp = _batch.comp_site_column(sp, w) + jp.work[g] / sp.cap
            row = torch.where(sp.alive, _batch.class_total(cls, net, comp, dtc[g]), math.inf)
            s, _ = _batch.argmin_finite(row)
            placements.append(self._place_group(group, sp.names[s]))
        return placements

    def _place_group(self, group: BulkGroup, best_site: str) -> GroupPlacement:
        """§VIII placement given the §V whole-group selection."""
        single_site_ok = self._fits(best_site, group.jobs)
        if single_site_ok and group.division_factor == 1:
            self._commit(best_site, group.jobs)
            return GroupPlacement(
                group_id=group.group_id,
                assignments={best_site: list(group.jobs)},
                output_location=group.output_location,
                split=False,
            )

        # Split path: even when one site fits, splitting may beat it
        # (Fig 4). Compare estimated makespans.
        caps = {name: s.capacity for name, s in self.diana.sites.items() if s.alive}
        alloc = allocate_proportional(group.size, group.division_factor, caps)
        if single_site_ok:
            single_span = group.total_work / self.diana.sites[best_site].capacity
            jobs_per = group.total_work / max(group.size, 1)
            split_span = average_makespan(alloc, caps, hours_per_job=jobs_per)
            if single_span <= split_span:
                self._commit(best_site, group.jobs)
                return GroupPlacement(
                    group_id=group.group_id,
                    assignments={best_site: list(group.jobs)},
                    output_location=group.output_location,
                    split=False,
                )

        assignments: dict[str, list[Job]] = {}
        cursor = 0
        # Deterministic order: biggest allocation first.
        for site_name, count in sorted(alloc.items(), key=lambda kv: -kv[1]):
            subjobs = group.jobs[cursor : cursor + count]
            cursor += count
            if not subjobs:
                continue
            self._commit(site_name, subjobs)
            assignments[site_name] = subjobs
        return GroupPlacement(
            group_id=group.group_id,
            assignments=assignments,
            output_location=group.output_location,
            split=True,
        )

    def _commit(self, site_name: str, jobs: Sequence[Job]) -> None:
        site = self.diana.sites[site_name]
        for j in jobs:
            site.queue_length += 1
            site.waiting_work += j.compute_work
            j.site = site_name

    def aggregate_outputs(self, placement: GroupPlacement) -> dict[str, float]:
        """§VIII: bytes moved per site → the group's output location."""
        return {
            site: sum(j.output_bytes for j in jobs)
            for site, jobs in placement.assignments.items()
        }


# ---------------------------------------------------------------------------
# Decentralized routing: each group goes to its submitting peer (§III).
# ---------------------------------------------------------------------------

def stable_user_peer(user: str, peers: Sequence):
    """Deterministic user→peer routing for submissions with no (or an
    unknown) submit site — crc32, not ``hash()``, so routing survives
    interpreter hash randomization."""
    if not peers:
        raise ValueError("no peers to route to")
    return peers[zlib.crc32(user.encode()) % len(peers)]


def submitting_peer(group: BulkGroup, peers: Sequence):
    """The peer a bulk submission enters the grid through: the peer whose
    ``home_sites`` hold ``group.submit_site``, else ``stable_user_peer``.
    ``peers`` are duck-typed (anything with ``home_sites``)."""
    if group.submit_site is not None:
        for p in peers:
            if group.submit_site in p.home_sites:
                return p
    return stable_user_peer(group.user, peers)


def route_groups(
    groups: Sequence[BulkGroup],
    peers: Sequence,
    max_group_fraction: float = 1.0,
    now: Optional[float] = None,
) -> list[tuple[object, GroupPlacement]]:
    """Route each §VIII group to its submitting peer and place it there
    (``peer.schedule_group(group, max_group_fraction, now=now)``).
    Returns (peer, placement) per group, in submission order."""
    out = []
    for g in groups:
        p = submitting_peer(g, peers)
        out.append((p, p.schedule_group(g, max_group_fraction, now=now)))
    return out
