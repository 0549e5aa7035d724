"""Batched (jobs × sites) placement engine (paper §IV/§V at bulk scale).

The paper's central loop — "after every job we calculate the cost to
submit the next job" — evaluated as one (J, S) plane with the
sequential queue feedback replayed between rows, so batched results are
bit-identical to the per-job loop:

* ``SitePack`` / ``JobPack`` hold the site columns and job demands as
  float64 tensors on one device (the CUDA card by default).
* ``cost_components`` computes the static §IV planes — ``net`` (S,),
  the per-site computation column (S,) and ``dtc`` (J, S) — with the
  scalar code's exact operation order, so costs match ``total_cost``/
  ``rank_sites`` to the last bit.
* ``batched_cost_matrix`` assembles the per-class (J, S) plane: the
  default ``backend="exact"`` is float64 through the ``cost_matrix_f64``
  kernel on the card (its plain version on the host); ``"kernel"`` is
  the float32 TPU-kernel port (``cost_matrix_classed``).
* ``replay_on_pack`` commits placements sequentially-equivalently: the
  static planes once, then per row only the computation term, from the
  running queue/work columns.

Only the flat half is ported; ``TierPack``/hier and
``merge_packed_rows`` are later slices (ROADMAP.md queue A).
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from .._device import resolve_device, sqrt_rn
from ..kernels.cost_matrix.ops import cost_argmin_f64, cost_matrix_classed, cost_matrix_f64
from .costs import CostWeights, NetworkLink, SiteState
from .queues import Job
from .scheduler import JobClass, classify

__all__ = [
    "PACK_FIELDS",
    "SitePack",
    "JobPack",
    "BatchPlacement",
    "argmin_finite",
    "class_total",
    "comp_site_column",
    "cost_components",
    "batched_cost_matrix",
    "batched_argmin",
    "fused_argmin",
    "replay_on_pack",
    "replay_place",
]

# Row order of the packed per-site float columns (the P2P wire's "(8, S)"
# layout in the reference, and the f64 kernels' site-row layout).
PACK_FIELDS = ("cap", "queue", "work", "load", "bw", "loss", "rtt", "mss")
_F64 = torch.float64
# Class codes of the kernels' int8 job column.
_CLASS_CODE = {JobClass.COMPUTE: 0, JobClass.DATA: 1, JobClass.BOTH: 2}


@dataclass
class SitePack:
    """Dense column-per-site view of ``sites``/``links`` dicts.

    Column order is the ``sites`` dict iteration order, which makes
    first-index argmin tie-breaking identical to the stable sorted walk
    of ``DianaScheduler.select_site``. Every column is an (S,) float64
    tensor (``alive`` bool) on one device.
    """

    names: list[str]
    cap: torch.Tensor       # Pi
    queue: torch.Tensor     # Qi
    work: torch.Tensor      # Q (aggregate queued work)
    load: torch.Tensor      # SiteLoad
    bw: torch.Tensor        # nominal bytes/s toward each site
    loss: torch.Tensor      # packet-loss fraction
    rtt: torch.Tensor       # round-trip seconds
    mss: torch.Tensor       # TCP MSS bytes (Mathis model)
    alive: torch.Tensor     # bool

    @property
    def device(self) -> torch.device:
        return self.cap.device

    @classmethod
    def from_arrays(cls, names: Sequence[str], *, device=None, **columns) -> "SitePack":
        """Pack (S,) columns given by name (PACK_FIELDS plus ``alive``) —
        NumPy arrays, lists or tensors — onto ``device`` (the card by
        default); float values are carried bit-exactly."""
        dev = resolve_device(device)
        missing = set(PACK_FIELDS + ("alive",)) - set(columns)
        if missing or len(columns) != len(PACK_FIELDS) + 1:
            raise TypeError(
                f"SitePack.from_arrays needs exactly {PACK_FIELDS + ('alive',)}, got {sorted(columns)}"
            )
        f64 = {f: torch.as_tensor(columns[f], dtype=_F64, device=dev) for f in PACK_FIELDS}
        alive = torch.as_tensor(columns["alive"], dtype=torch.bool, device=dev)
        return cls(names=list(names), alive=alive, **f64)

    @classmethod
    def from_scheduler(
        cls,
        sites: dict[str, SiteState],
        links: dict[str, NetworkLink],
        order: Optional[Sequence[str]] = None,
        *,
        device=None,
    ) -> "SitePack":
        names = list(order) if order is not None else list(sites)
        return cls.from_arrays(
            names,
            device=device,
            cap=[sites[n].capacity for n in names],
            queue=[sites[n].queue_length for n in names],
            work=[sites[n].waiting_work for n in names],
            load=[sites[n].load for n in names],
            bw=[links[n].bandwidth_Bps for n in names],
            loss=[links[n].loss_rate for n in names],
            rtt=[links[n].rtt_s for n in names],
            mss=[links[n].mss_bytes for n in names],
            alive=[sites[n].alive for n in names],
        )

    def refresh_dynamic(
        self,
        sites: dict[str, SiteState],
        only: Optional[Sequence[str]] = None,
        missing: str = "raise",
    ) -> None:
        """Re-read queue/work/load/alive (between replay rounds).

        ``only`` restricts the refresh to the named columns. A name in
        ``only`` that has no column is a caller bug: ``missing="raise"``
        (the default) raises ``KeyError`` naming the offenders;
        ``missing="warn"`` skips them with a warning instead.
        """
        if missing not in ("raise", "warn"):
            raise ValueError(f"missing must be 'raise' or 'warn', got {missing!r}")
        if only is None:
            pairs: Sequence[tuple[int, str]] = list(enumerate(self.names))
        else:
            idx = {n: i for i, n in enumerate(self.names)}
            unknown = [n for n in only if n not in idx]
            if unknown:
                if missing == "raise":
                    raise KeyError(
                        f"refresh_dynamic: unknown site id(s) in only={unknown!r}; "
                        f"pack columns are {self.names!r}"
                    )
                warnings.warn(
                    f"refresh_dynamic: ignoring unknown site id(s) {unknown!r}",
                    stacklevel=2,
                )
            pairs = [(idx[n], n) for n in only if n in idx]
        if not pairs:
            return
        # One host→device copy per column instead of one per element.
        cols = torch.as_tensor([i for i, _ in pairs], device=self.device)
        states = [sites[n] for _, n in pairs]
        dev = self.device
        self.queue[cols] = torch.as_tensor([s.queue_length for s in states], dtype=_F64, device=dev)
        self.work[cols] = torch.as_tensor([s.waiting_work for s in states], dtype=_F64, device=dev)
        self.load[cols] = torch.as_tensor([s.load for s in states], dtype=_F64, device=dev)
        self.alive[cols] = torch.as_tensor([s.alive for s in states], dtype=torch.bool, device=dev)

    def refresh_from(
        self,
        provider,
        only: Optional[Sequence[str]] = None,
        missing: str = "raise",
    ) -> None:
        """Incremental refresh through ``provider(name) -> SiteState``,
        consulted only for the ``only`` columns (all when omitted)."""
        names = self.names if only is None else list(only)
        self.refresh_dynamic({n: provider(n) for n in names}, only=names, missing=missing)

    def pack_rows(self, cols=None) -> torch.Tensor:
        """The (8, S) float64 packed view in PACK_FIELDS order (the f64
        kernels' site rows); with ``cols`` (k,) just those columns."""
        rows = torch.stack([getattr(self, f) for f in PACK_FIELDS])
        return rows if cols is None else rows[:, torch.as_tensor(cols, device=self.device)]

    def set_columns(
        self,
        cols,
        rows,
        alive=None,
        fields: Optional[Sequence[str]] = None,
    ) -> None:
        """Write (8, k) packed ``rows`` (PACK_FIELDS order) into columns
        ``cols``; ``alive`` optionally overwrites the liveness bits;
        ``fields`` restricts the write to a subset of PACK_FIELDS."""
        dev = self.device
        cols = torch.as_tensor(cols, dtype=torch.int64, device=dev)
        rows = torch.as_tensor(rows, dtype=_F64, device=dev)
        for r, f in enumerate(PACK_FIELDS):
            if fields is None or f in fields:
                getattr(self, f)[cols] = rows[r]
        if alive is not None:
            self.alive[cols] = torch.as_tensor(alive, dtype=torch.bool, device=dev)


@dataclass
class JobPack:
    """(J,) demand columns plus the §V class of each job.

    ``wcomp``/``wdtc`` are the float32 kernel's class masks (COMPUTE
    keeps the computation plane, DATA the data-transfer plane, BOTH
    both); ``cls`` is the float64 kernels' int8 class code.
    """

    bytes_: torch.Tensor    # (J,) float64 total bytes to move per job
    work: torch.Tensor      # (J,) float64 compute work per job
    wcomp: torch.Tensor     # (J,) 1.0 where the class includes computation cost
    wdtc: torch.Tensor      # (J,) 1.0 where the class includes data-transfer cost
    cls: torch.Tensor       # (J,) int8: 0 COMPUTE, 1 DATA, 2 BOTH
    classes: list[JobClass]

    @classmethod
    def from_jobs(
        cls,
        jobs: Sequence[Job],
        job_classes: Optional[Sequence[Optional[JobClass]]] = None,
        *,
        device=None,
    ) -> "JobPack":
        dev = resolve_device(device)
        if job_classes is None:
            job_classes = [None] * len(jobs)
        classes = [c or classify(j) for j, c in zip(jobs, job_classes)]
        f64 = lambda xs: torch.as_tensor(xs, dtype=_F64, device=dev)  # noqa: E731
        return cls(
            bytes_=f64([j.total_bytes for j in jobs]),
            work=f64([j.compute_work for j in jobs]),
            wcomp=f64([1.0 if c in (JobClass.COMPUTE, JobClass.BOTH) else 0.0 for c in classes]),
            wdtc=f64([1.0 if c in (JobClass.DATA, JobClass.BOTH) else 0.0 for c in classes]),
            cls=torch.as_tensor([_CLASS_CODE[c] for c in classes], dtype=torch.int8, device=dev),
            classes=classes,
        )


@dataclass
class BatchPlacement:
    """Result of a batched §V selection over J jobs."""

    site_indices: torch.Tensor   # (J,) int64 column index per job
    sites: list[str]             # per-job chosen site name
    costs: torch.Tensor          # (J,) float64 chosen-site cost
    classes: list[JobClass]


# ---------------------------------------------------------------------------
# Static §IV component planes (float64, scalar-identical operation order).
# ---------------------------------------------------------------------------

def comp_site_column(sites: SitePack, weights: CostWeights = CostWeights()) -> torch.Tensor:
    """Job-independent §IV computation term, W5·Qi/Pi + W6·Q/Pi +
    W7·load, in ``computation_cost``'s exact evaluation order (add
    ``job_work / cap`` for the full per-job term)."""
    return (
        weights.w_queue * sites.queue / sites.cap
        + weights.w_work * sites.work / sites.cap
        + weights.w_load * sites.load
    )


def cost_components(
    jobs: JobPack, sites: SitePack, weights: CostWeights = CostWeights()
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return ``(net (S,), comp_site (S,), dtc (J, S))``, each bit-identical
    to ``network_cost`` / ``computation_cost`` / ``data_transfer_cost``."""
    net = (sites.loss / sites.bw) * 1.0e6
    mathis = sites.mss / (sites.rtt * sqrt_rn(sites.loss))
    eff_bw = torch.where(sites.loss > 0.0, torch.minimum(sites.bw, mathis), sites.bw)
    dtc = jobs.bytes_[:, None] / eff_bw[None, :]
    return net, comp_site_column(sites, weights), dtc


def class_total(cls: JobClass, net, comp, dtc):
    """Per-class §IV total with the scalar rank-key addition order —
    COMPUTE = comp + net, DATA = dtc + net, BOTH = (net + comp) + dtc.
    Broadcasts over (S,) rows and (J, S) planes; ``comp`` may be None
    for DATA (unused)."""
    if cls is JobClass.DATA:
        return dtc + net
    if cls is JobClass.COMPUTE:
        return comp + net
    return (net + comp) + dtc


def batched_cost_matrix(
    jobs: JobPack,
    sites: SitePack,
    weights: CostWeights = CostWeights(),
    *,
    mask_dead: bool = True,
    backend: str = "exact",
) -> torch.Tensor:
    """One-shot per-class §IV cost over (J, S) on the packs' device;
    dead sites +inf.

    ``backend="exact"``  — float64, bit-identical to the scalar loop
    (the reference's ``"numpy"``).
    ``backend="kernel"`` — the float32 port of the TPU kernel, widened
    to float64.
    """
    w = dict(w_queue=weights.w_queue, w_work=weights.w_work, w_load=weights.w_load)
    if backend == "kernel":
        s = [c.float() for c in (sites.cap, sites.queue, sites.work, sites.load,
                                 sites.bw, sites.loss, sites.rtt)]
        alive = sites.alive if mask_dead else torch.ones_like(sites.alive)
        cost, _ = cost_matrix_classed(
            jobs.bytes_.float(), jobs.work.float(), jobs.wcomp.float(), jobs.wdtc.float(),
            *s, alive, sites.mss.float(), **w,
        )
        cost = cost.double()
        if mask_dead:
            cost.masked_fill_(~sites.alive[None, :], math.inf)
        return cost
    if backend != "exact":
        raise ValueError(f"unknown backend {backend!r}")
    return cost_matrix_f64(
        jobs.bytes_, jobs.work, jobs.cls, sites.pack_rows(), sites.alive,
        mask_dead=mask_dead, **w,
    )


def argmin_finite(row: torch.Tensor) -> tuple[int, float]:
    """Cheapest column of one (inf-masked) cost row — first index wins
    ties, matching the stable sequential ranking walk; raises when no
    finite (alive) column remains."""
    s = int(torch.argmin(row))
    cost = float(row[s])
    if not math.isfinite(cost):
        raise RuntimeError("no alive site available")
    return s, cost


def _placement(sites: SitePack, idx: torch.Tensor, costs: torch.Tensor, classes) -> BatchPlacement:
    return BatchPlacement(
        site_indices=idx,
        sites=[sites.names[i] for i in idx.tolist()],
        costs=costs,
        classes=classes,
    )


def batched_argmin(cost: torch.Tensor, sites: SitePack) -> BatchPlacement:
    """Per-job cheapest alive site of a (J, S) plane (first index wins
    ties, like the stable sequential ranking walk)."""
    idx = torch.argmin(cost, dim=1)
    picked = cost.gather(1, idx[:, None])[:, 0]
    if not bool(torch.isfinite(picked).all()):
        raise RuntimeError("no alive site available")
    return _placement(sites, idx, picked, [])


def fused_argmin(
    jobs: JobPack, sites: SitePack, weights: CostWeights = CostWeights()
) -> BatchPlacement:
    """``batched_argmin(batched_cost_matrix(jobs, sites, weights), sites)``
    in one pass: on the card the fused kernel never writes the (J, S)
    plane."""
    idx, costs = cost_argmin_f64(
        jobs.bytes_, jobs.work, jobs.cls, sites.pack_rows(), sites.alive,
        w_queue=weights.w_queue, w_work=weights.w_work, w_load=weights.w_load,
    )
    return _placement(sites, idx, costs, jobs.classes)


# ---------------------------------------------------------------------------
# Sequential-equivalent replay: commit placements between matrix rows.
# ---------------------------------------------------------------------------

def replay_on_pack(
    jp: JobPack,
    sp: SitePack,
    weights: CostWeights = CostWeights(),
) -> BatchPlacement:
    """The replay core against any ``SitePack`` view.

    The static planes (network + data-transfer) are evaluated once for
    the whole batch; between rows only the computation term is
    re-derived from the running queue-length / waiting-work columns.
    The pack's queue/work columns are updated with the per-placement
    feedback. Site choices and costs are bit-identical to the
    sequential per-job loop over the same view.

    One row is a handful of small device operations and one readback,
    so on the card this loop is bound by launches, not by the device.
    """
    net, comp_base, dtc = cost_components(jp, sp, weights)
    comp_base = comp_base.clone()
    dead = ~sp.alive
    # Dead sites poison every class branch through the (always-present)
    # network plane: +inf propagates through the remaining additions.
    net_m = torch.where(dead, math.inf, net)
    dtc_m = dtc.masked_fill(dead[None, :], math.inf)

    # The feedback touches one site per row: its queue/work/computation
    # entries are kept on the host in Python floats (IEEE doubles, the
    # same operations as the reference's NumPy scalars).
    q, w, cap = sp.queue.tolist(), sp.work.tolist(), sp.cap.tolist()
    load_term = (weights.w_load * sp.load).tolist()
    wq, ww = weights.w_queue, weights.w_work
    work = jp.work.tolist()

    J = len(jp.classes)
    site_idx = [0] * J
    costs = [0.0] * J
    for j in range(J):
        cls = jp.classes[j]
        comp = None if cls is JobClass.DATA else comp_base + jp.work[j] / sp.cap
        s, cost = argmin_finite(class_total(cls, net_m, comp, dtc_m[j]))
        site_idx[j] = s
        costs[j] = cost
        q[s] += 1.0
        w[s] += work[j]
        # Same elementwise expression as comp_site_column, so the entry
        # stays bit-identical to a full recomputation.
        comp_base[s] = (wq * q[s] / cap[s] + ww * w[s] / cap[s]) + load_term[s]

    dev = sp.device
    sp.queue.copy_(torch.as_tensor(q, dtype=_F64, device=dev))
    sp.work.copy_(torch.as_tensor(w, dtype=_F64, device=dev))
    return BatchPlacement(
        site_indices=torch.as_tensor(site_idx, dtype=torch.int64, device=dev),
        sites=[sp.names[i] for i in site_idx],
        costs=torch.as_tensor(costs, dtype=_F64, device=dev),
        classes=jp.classes,
    )


def replay_place(
    jobs: Sequence[Job],
    sites: dict[str, SiteState],
    links: dict[str, NetworkLink],
    weights: CostWeights = CostWeights(),
    job_classes: Optional[Sequence[Optional[JobClass]]] = None,
    commit: bool = True,
    *,
    device=None,
) -> BatchPlacement:
    """Batched equivalent of ``[DianaScheduler.place(j) for j in jobs]``
    on ``device`` (the card by default): packs the dicts, runs
    ``replay_on_pack`` and commits the queue/work columns back."""
    sp = SitePack.from_scheduler(sites, links, device=device)
    jp = JobPack.from_jobs(jobs, job_classes, device=sp.device)
    placement = replay_on_pack(jp, sp, weights)
    if commit:
        for job, name in zip(jobs, placement.sites):
            job.site = name
        for name, qv, wv in zip(sp.names, sp.queue.tolist(), sp.work.tolist()):
            sites[name].queue_length = qv
            sites[name].waiting_work = wv
    return placement
