"""DIANA site-selection algorithm (paper §V).

Three branches on job class:

  compute-intensive:            rank sites by computation + network cost
  data-intensive:               rank sites by data-transfer + network cost
  data- AND compute-intensive:  rank by total cost (all three terms)

then walk the ranked list and pick the first *alive* site. The
scheduler keeps per-site dynamic state and the link table, so after
every placement the next job sees updated queue lengths.

The scalar paths are plain Python; the batch paths build packs on the
scheduler's ``device`` (the CUDA card unless ``device="cpu"``) and run
the §IV planes there.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional, Sequence

from .._device import resolve_device
from .costs import (
    CostWeights,
    JobDemand,
    NetworkLink,
    SiteState,
    computation_cost,
    data_transfer_cost,
    network_cost,
)
from .queues import Job

if TYPE_CHECKING:
    from .batch import BatchPlacement
    from .engine import PlacementEngine

__all__ = ["JobClass", "classify", "DianaScheduler", "SiteDecision"]


class JobClass(enum.Enum):
    COMPUTE = "compute"
    DATA = "data"
    BOTH = "both"


def classify(job: Job, data_threshold: float = 1.0, compute_threshold: float = 1.0) -> JobClass:
    """Classify a job by its dominant demand (GB of data vs
    processor·hours of compute, with configurable thresholds)."""
    data_gb = job.total_bytes / 1e9
    heavy_data = data_gb > data_threshold
    heavy_compute = job.compute_work > compute_threshold
    if heavy_data and heavy_compute:
        return JobClass.BOTH
    if heavy_data:
        return JobClass.DATA
    return JobClass.COMPUTE


@dataclass
class SiteDecision:
    site: str
    cost: float
    ranking: list[tuple[str, float]]   # all (site, cost) in ascending order
    job_class: JobClass


def _check_mode(mode: str) -> None:
    if mode not in ("flat", "hier"):
        raise ValueError(f"mode must be 'flat' or 'hier', got {mode!r}")


class DianaScheduler:
    """Per-instance DIANA meta-scheduler (one per RootGrid).

    ``sites``: dynamic SiteState per peer (including the local site).
    ``links``: NetworkLink from *this* scheduler's site toward each peer.
    ``topology``: optional ``GridTopology``, the default tier structure
    of the two-level batch paths (``mode="hier"``); None = one tier.
    ``device``: where the batch paths run; None → the CUDA card, which
    raises when there is none.
    """

    def __init__(
        self,
        sites: dict[str, SiteState],
        links: dict[str, NetworkLink],
        weights: CostWeights = CostWeights(),
        topology=None,
        *,
        device=None,
    ):
        self.sites = sites
        self.links = links
        self.weights = weights
        self.topology = topology
        self.device = resolve_device(device)

    @property
    def engine(self) -> "PlacementEngine":
        """The pure placement algorithm, derived per access so a mutated
        ``self.weights`` reaches every batch API."""
        from .engine import PlacementEngine  # late: engine imports batch

        return PlacementEngine(self.weights)

    # -- §IV cost vectors ----------------------------------------------------
    def cost_vectors(self, demand: JobDemand) -> dict[str, tuple[float, float, float]]:
        """(network, computation, data-transfer) per site, in seconds."""
        out: dict[str, tuple[float, float, float]] = {}
        for name, site in self.sites.items():
            link = self.links[name]
            net = network_cost(link)
            comp = computation_cost(site, self.weights) + demand.compute_work / site.capacity
            dtc = data_transfer_cost(demand, link)
            out[name] = (net, comp, dtc)
        return out

    # -- §V selection ----------------------------------------------------------
    def rank_sites(self, job: Job, job_class: Optional[JobClass] = None) -> list[tuple[str, float]]:
        demand = JobDemand(
            compute_work=job.compute_work,
            input_bytes=job.input_bytes,
            output_bytes=job.output_bytes,
            executable_bytes=job.executable_bytes,
        )
        job_class = job_class or classify(job)
        vecs = self.cost_vectors(demand)
        key = {
            JobClass.COMPUTE: lambda v: v[1] + v[0],
            JobClass.DATA: lambda v: v[2] + v[0],
            JobClass.BOTH: lambda v: v[0] + v[1] + v[2],
        }[job_class]
        return sorted(((name, key(v)) for name, v in vecs.items()), key=lambda kv: kv[1])

    def select_site(self, job: Job, job_class: Optional[JobClass] = None) -> SiteDecision:
        """§V: walk the ascending-cost ranking, first alive site wins."""
        job_class = job_class or classify(job)
        ranking = self.rank_sites(job, job_class)
        for name, cost in ranking:
            if self.sites[name].alive:
                return SiteDecision(site=name, cost=cost, ranking=ranking, job_class=job_class)
        raise RuntimeError("no alive site available")

    def place(self, job: Job, job_class: Optional[JobClass] = None) -> SiteDecision:
        """Select a site and commit the job to its queue state."""
        decision = self.select_site(job, job_class)
        site = self.sites[decision.site]
        site.queue_length += 1
        site.waiting_work += job.compute_work
        job.site = decision.site
        return decision

    # -- batched paths (repro_torch.core.batch) ----------------------------
    def _packs(self, jobs, job_classes):
        from . import batch as _batch

        sp = _batch.SitePack.from_scheduler(self.sites, self.links, device=self.device)
        return self.engine.pack_jobs(jobs, job_classes, device=self.device), sp

    def rank_sites_batch(
        self,
        jobs: Sequence[Job],
        job_classes: Optional[Sequence[Optional[JobClass]]] = None,
    ) -> list[list[tuple[str, float]]]:
        """Vectorized ``rank_sites``: one (J, S) §IV plane instead of J
        Python loops; rankings (order and costs) are bit-identical to
        the per-job path, dead sites included."""
        jp, sp = self._packs(jobs, job_classes)
        return self.engine.rank(jp, sp)

    def select_sites_batch(
        self,
        jobs: Sequence[Job],
        job_classes: Optional[Sequence[Optional[JobClass]]] = None,
        *,
        mode: str = "flat",
        tiers=None,
    ) -> "BatchPlacement":
        """Batched ``select_site`` with no state commit: every job sees
        the same snapshot, like J independent ``select_site`` calls.

        ``mode="hier"`` routes through the two-level tier-bound path
        (bit-identical decisions, no (J, S) plane); ``tiers`` overrides
        the scheduler's ``topology`` as the tier structure.
        """
        from . import batch as _batch

        _check_mode(mode)
        jp, sp = self._packs(jobs, job_classes)
        if mode == "hier":
            tp = _batch.TierPack.from_site_pack(sp, self.topology if tiers is None else tiers)
            return self.engine.select_hier(jp, sp, tp)
        return self.engine.select(jp, sp)

    def place_batch(
        self,
        jobs: Sequence[Job],
        job_classes: Optional[Sequence[Optional[JobClass]]] = None,
        *,
        mode: str = "flat",
        tiers=None,
    ) -> "BatchPlacement":
        """Batched ``place`` loop: the static §IV planes once, the
        per-placement queue feedback replayed between rows, so choices,
        costs and final site state are bit-identical to
        ``[self.place(j) for j in jobs]``.

        ``mode="hier"`` commits the same placements through the
        two-level tier-bound path (see ``select_sites_batch``).
        """
        from . import batch as _batch

        _check_mode(mode)
        if mode == "hier":
            jp, sp = self._packs(jobs, job_classes)
            tp = _batch.TierPack.from_site_pack(sp, self.topology if tiers is None else tiers)
            placement = self.engine.replay_hier(jp, sp, tp)
            for job, name in zip(jobs, placement.sites):
                job.site = name
            for name, qv, wv in zip(sp.names, sp.queue.tolist(), sp.work.tolist()):
                self.sites[name].queue_length = qv
                self.sites[name].waiting_work = wv
            return placement
        return _batch.replay_place(
            jobs, self.sites, self.links, self.weights, job_classes,
            commit=True, device=self.device,
        )

    def complete(self, job: Job) -> None:
        """Release a finished job's claim on its site."""
        if job.site is None:
            return
        site = self.sites[job.site]
        site.queue_length = max(0.0, site.queue_length - 1)
        site.waiting_work = max(0.0, site.waiting_work - job.compute_work)
