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
* ``TierPack`` / ``hier_select`` / ``hier_replay`` are the two-level
  ("hier") twins of the flat select and replay: per-tier admissible
  bounds, an f32 shortlist inside the winning tiers and an exact f64
  refinement, with decisions and costs bit-identical to the flat path.

``merge_packed_rows`` (P2P's only caller) is a later slice (ROADMAP.md
queue A, step 9).
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
from .migration import first_min_index
from .queues import Job
from .scheduler import JobClass, classify

__all__ = [
    "PACK_FIELDS",
    "SitePack",
    "JobPack",
    "BatchPlacement",
    "TierPack",
    "argmin_finite",
    "class_total",
    "comp_site_column",
    "cost_components",
    "batched_cost_matrix",
    "batched_argmin",
    "fused_argmin",
    "hier_replay",
    "hier_select",
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


# ---------------------------------------------------------------------------
# Two-level placement: tier summaries + pruned argmin ("hier" mode).
#
# A tier is a group of pack columns (a RootGrid of GridTopology, §IX).
# Each tier carries an admissible optimistic summary — a lower bound on
# every member's §IV cost from per-component extrema — so a job ranks
# the tiers by bound and refines only inside the winning tier, widening
# to runner-up tiers while their bound can still beat the refined best.
# Refinement scores the tier's columns in f32, shortlists everything
# within a relative tolerance of the f32 minimum, and re-evaluates the
# shortlist in exact f64 with the scalar operation order, so decisions
# and costs stay bit-identical to the flat dense argmin.
#
# On the card one row is a few dozen small launches and one readback a
# refined tier: the walk is bound by launches, like replay_on_pack.
# ---------------------------------------------------------------------------

# f32 shortlist tolerance: the score is fewer than 10 rounding steps over
# nonnegative terms, so its relative error is below ~6e-7; 1e-5 keeps a
# tenfold margin. Scores outside the magnitude window (or with negative
# inputs, see _f32_gate) refine whole tiers in exact f64.
_F32_SHORTLIST_RTOL = 1e-5
_F32_SHORTLIST_MIN = 1e-30
_F32_SHORTLIST_MAX = 1e30
# Finite tier bounds are nudged down by a relative ulp-scale guard so f64
# rounding in the bound arithmetic can never lift a bound above a
# member's true cost (which would prune the winning tier).
_BOUND_GUARD_RTOL = 1e-12


def _link_planes(loss, bw, rtt, mss) -> tuple[torch.Tensor, torch.Tensor]:
    """``(net, eff_bw)`` columns in ``cost_components``' exact order."""
    net = (loss / bw) * 1.0e6
    mathis = mss / (rtt * sqrt_rn(loss))
    eff = torch.where(loss > 0.0, torch.minimum(bw, mathis), bw)
    return net, eff


def _static_site_planes(sp: SitePack) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-site ``(net, eff_bw)`` in ``cost_components``' exact op
    order, alive-independent (no dead poisoning)."""
    return _link_planes(sp.loss, sp.bw, sp.rtt, sp.mss)


def _tier_reduce(x: torch.Tensor, pad: torch.Tensor, padmask: torch.Tensor, op: str) -> torch.Tensor:
    """Per-tier min or max of a per-site column over the (T, L) padded
    member table: exact in any order, NaN-propagating like ``np.min``."""
    fill = math.inf if op == "min" else -math.inf
    g = x[pad].masked_fill(padmask, fill)
    return g.amin(dim=1) if op == "min" else g.amax(dim=1)


@dataclass
class TierPack:
    """Tier membership + static summaries over a ``SitePack``, as tensors
    on the pack's device.

    Holds only static per-site planes (net, eff_bw — functions of the
    link fields) plus their per-tier extrema and f32 copies for the
    shortlist score. Dynamic state (queue/work/load/alive) is read live
    from the ``SitePack``; only changes to link fields or capacity need
    ``refresh`` (narrowable to the dirty columns).
    """

    labels: list[str]              # tier label per tier index
    tier_of: torch.Tensor          # (S,) int64 tier index per pack column
    members: list[torch.Tensor]    # per-tier ascending column indices
    pad: torch.Tensor              # (T, L) member columns, padded with the tier's first
    padmask: torch.Tensor          # (T, L) True on padding
    net64: torch.Tensor            # (S,) float64 network term, unpoisoned
    eff64: torch.Tensor            # (S,) float64 effective bandwidth
    net32: torch.Tensor            # (S,) float32 copies for the shortlist score
    eff32: torch.Tensor
    cap32: torch.Tensor
    net_min: torch.Tensor          # (T,) per-tier extrema for the bounds
    eff_max: torch.Tensor
    eff_min: torch.Tensor
    cap_max: torch.Tensor
    cap_min: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.net64.device

    @classmethod
    def from_site_pack(cls, sp: SitePack, tiers=None) -> "TierPack":
        """Build the tier index over ``sp``'s columns, on ``sp``'s device.

        ``tiers`` may be ``None`` (every site in one tier), a
        ``{site: tier_label}`` dict (unmapped sites become singleton
        tiers named after themselves), or a ``GridTopology`` (tier =
        RootGrid, via ``site_tiers``).
        """
        names = sp.names
        if tiers is None:
            mapping = {n: "grid" for n in names}
        elif isinstance(tiers, dict):
            mapping = {n: tiers.get(n, n) for n in names}
        elif hasattr(tiers, "site_tiers"):
            mapping = tiers.site_tiers(names)
        else:
            raise TypeError(
                f"tiers must be None, a dict or a GridTopology, got {type(tiers)!r}"
            )
        labels: list[str] = []
        index: dict[str, int] = {}
        tier_of: list[int] = []
        groups: list[list[int]] = []
        for i, n in enumerate(names):
            lab = mapping[n]
            t = index.get(lab)
            if t is None:
                t = len(labels)
                index[lab] = t
                labels.append(lab)
                groups.append([])
            tier_of.append(t)
            groups[t].append(i)
        dev = sp.device
        S, T = len(names), len(labels)
        L = max((len(g) for g in groups), default=0)
        f64 = lambda n: torch.empty(n, dtype=_F64, device=dev)  # noqa: E731
        f32 = lambda n: torch.empty(n, dtype=torch.float32, device=dev)  # noqa: E731
        tp = cls(
            labels=labels,
            tier_of=torch.as_tensor(tier_of, dtype=torch.int64, device=dev),
            members=[torch.as_tensor(g, dtype=torch.int64, device=dev) for g in groups],
            pad=torch.as_tensor([g + [g[0]] * (L - len(g)) for g in groups],
                                dtype=torch.int64, device=dev).reshape(T, L),
            padmask=torch.as_tensor([[False] * len(g) + [True] * (L - len(g)) for g in groups],
                                    dtype=torch.bool, device=dev).reshape(T, L),
            net64=f64(S), eff64=f64(S), net32=f32(S), eff32=f32(S), cap32=f32(S),
            net_min=f64(T), eff_max=f64(T), eff_min=f64(T), cap_max=f64(T), cap_min=f64(T),
        )
        tp.refresh(sp)
        return tp

    def refresh(self, sp: SitePack, cols=None) -> None:
        """Recompute static planes + summaries, narrowed to ``cols``.

        Call whenever link fields (bw/loss/rtt/mss) or capacity changed
        on some columns; tier summaries are re-aggregated only for the
        tiers holding a touched column.
        """
        if cols is None:
            net, eff = _static_site_planes(sp)
            self.net64.copy_(net)
            self.eff64.copy_(eff)
            self.cap32.copy_(sp.cap.float())
            touched = None
        else:
            cols = torch.as_tensor(cols, dtype=torch.int64, device=self.device)
            if cols.numel() == 0:
                return
            net, eff = _link_planes(sp.loss[cols], sp.bw[cols], sp.rtt[cols], sp.mss[cols])
            self.net64[cols] = net
            self.eff64[cols] = eff
            self.cap32[cols] = sp.cap[cols].float()
            touched = torch.zeros(len(self.labels), dtype=torch.bool, device=self.device)
            touched[self.tier_of[cols]] = True
        self.net32.copy_(self.net64.float())
        self.eff32.copy_(self.eff64.float())
        for name, col, op in (("net_min", self.net64, "min"), ("eff_max", self.eff64, "max"),
                              ("eff_min", self.eff64, "min"), ("cap_max", sp.cap, "max"),
                              ("cap_min", sp.cap, "min")):
            new = _tier_reduce(col, self.pad, self.padmask, op)
            old = getattr(self, name)
            old.copy_(new if touched is None else torch.where(touched, new, old))

    def comp_tier_min(self, comp: torch.Tensor) -> torch.Tensor:
        """Per-tier minimum of a per-site computation column."""
        return _tier_reduce(comp, self.pad, self.padmask, "min")


def _f32_gate(jp: JobPack, sp: SitePack, tp: TierPack, weights: CostWeights) -> bool:
    """True when the f32 shortlist's relative-error bound is sound: all
    score terms nonnegative (no cancellation) and capacities positive.
    Otherwise refinement evaluates whole tiers in exact f64 — still
    tier-pruned, just without the f32 narrowing."""
    if weights.w_queue < 0.0 or weights.w_work < 0.0 or weights.w_load < 0.0:
        return False
    flags = [(a >= 0.0).all() for a in (tp.net64, tp.eff64, sp.queue, sp.work, sp.load,
                                        jp.work, jp.bytes_)]
    flags += [(sp.cap > 0.0).all(), torch.isfinite(sp.cap).all()]
    return bool(torch.stack(flags).all())


def _hier_argmin_row(
    tp: TierPack,
    sp: SitePack,
    cls: JobClass,
    bytes_j: float,
    work_j: float,
    comp_base: torch.Tensor,
    comp_min: torch.Tensor,
    use32: bool,
) -> tuple[int, float]:
    """One job's two-level argmin: ``(column, cost)`` bit-identical to
    ``argmin_finite`` over the flat dense row, or ``(-1, inf)`` when no
    alive/finite column exists.

    ``comp_base`` is the job-independent computation column (the full
    per-job term is ``comp_base + work_j / cap``); ``comp_min`` its
    per-tier minimum, maintained by the caller. Every quotient of a
    Python float by a column divides tensor by tensor (``full_like``),
    never ``scalar / tensor`` (see ``repro_torch._device``).
    """
    has_comp = cls is not JobClass.DATA
    has_dtc = cls is not JobClass.COMPUTE
    comp_lb = None
    if has_comp:
        cap = tp.cap_max if work_j >= 0.0 else tp.cap_min
        comp_lb = comp_min + torch.full_like(cap, work_j) / cap
    dtc_lb = None
    if has_dtc:
        if bytes_j == 0.0:
            # 0/eff is 0 for every finite eff; the shortcut dodges the
            # 0/0 NaN an all-zero-bandwidth tier would inject.
            dtc_lb = torch.zeros_like(tp.eff_max)
        else:
            eff = tp.eff_max if bytes_j > 0.0 else tp.eff_min
            dtc_lb = torch.full_like(eff, bytes_j) / eff
    bound = class_total(cls, tp.net_min, comp_lb, dtc_lb)
    # NaN bounds (degenerate link values) carry no pruning information:
    # -inf makes the tier always refined, never skipped.
    bound = torch.where(torch.isnan(bound), -math.inf, bound)
    bound = torch.where(torch.isfinite(bound), bound - bound.abs() * _BOUND_GUARD_RTOL, bound)
    order = torch.argsort(bound, stable=True)
    bound_h, order_h = torch.stack((bound, order.to(_F64))).tolist()

    if use32:
        b32 = torch.full_like(tp.eff32, bytes_j)
        w32 = torch.full_like(tp.cap32, work_j)
    best_cost = math.inf
    best_col = -1
    for t in order_h:
        t = int(t)
        # <= (not <): a runner-up tier whose bound ties the refined best
        # may hold an equal-cost column with a lower index, which the
        # flat argmin's first-index tie-break would pick.
        if bound_h[t] > best_cost:
            break
        cols = tp.members[t]
        dead = ~sp.alive[cols]
        keep = None
        if use32:
            n32 = tp.net32[cols]
            if cls is JobClass.DATA:
                score = (b32[cols] / tp.eff32[cols]) + n32
            else:
                comp32 = comp_base[cols].float() + w32[cols] / tp.cap32[cols]
                if cls is JobClass.COMPUTE:
                    score = comp32 + n32
                else:
                    score = (n32 + comp32) + (b32[cols] / tp.eff32[cols])
            score = score.masked_fill(dead, math.inf)
            m32 = score.amin().double()
            # NumPy compares the f32 scores with the f64 threshold cast
            # to f32 (a Python float is a weak scalar).
            thr = (m32 * (1.0 + _F32_SHORTLIST_RTOL)).float()
            window = (m32 > _F32_SHORTLIST_MIN) & (m32 < _F32_SHORTLIST_MAX)
            keep = (score <= thr) | ~window
        # Exact f64 refinement: elementwise ops on column slices equal
        # the sliced full-row results, so the costs match the flat dense
        # row bit for bit. Off-shortlist columns are masked to +inf in
        # place of being dropped: the first minimum among the shortlist
        # is unchanged, and a non-finite result is discarded either way.
        comp_s = None
        if has_comp:
            cap_s = sp.cap[cols]
            comp_s = comp_base[cols] + torch.full_like(cap_s, work_j) / cap_s
        dtc_s = None
        if has_dtc:
            eff_s = tp.eff64[cols]
            dtc_s = torch.full_like(eff_s, bytes_j) / eff_s
        row = class_total(cls, tp.net64[cols], comp_s, dtc_s).masked_fill(dead, math.inf)
        if keep is not None:
            row = row.masked_fill(~keep, math.inf)
        k = first_min_index(row)
        col, c = torch.stack((cols[k].to(_F64), row[k])).tolist()
        if math.isfinite(c):
            col = int(col)
            if c < best_cost or (c == best_cost and col < best_col):
                best_cost, best_col = c, col
    return best_col, best_cost


def hier_select(
    jp: JobPack,
    sp: SitePack,
    tp: TierPack,
    weights: CostWeights = CostWeights(),
) -> BatchPlacement:
    """Two-level equivalent of ``fused_argmin(jp, sp, weights)`` —
    snapshot costs, no between-row feedback — without ever
    materializing the (J, S) plane."""
    comp_site = comp_site_column(sp, weights)
    comp_min = tp.comp_tier_min(comp_site)
    use32 = _f32_gate(jp, sp, tp, weights)
    J = len(jp.classes)
    idx = [0] * J
    costs = [0.0] * J
    bytes_, work = jp.bytes_.tolist(), jp.work.tolist()
    for j in range(J):
        col, c = _hier_argmin_row(tp, sp, jp.classes[j], bytes_[j], work[j],
                                  comp_site, comp_min, use32)
        if col < 0:
            raise RuntimeError("no alive site available")
        idx[j] = col
        costs[j] = c
    dev = sp.device
    return BatchPlacement(
        site_indices=torch.as_tensor(idx, dtype=torch.int64, device=dev),
        sites=[sp.names[i] for i in idx],
        costs=torch.as_tensor(costs, dtype=_F64, device=dev),
        classes=list(jp.classes),
    )


def hier_replay(
    jp: JobPack,
    sp: SitePack,
    tp: TierPack,
    weights: CostWeights = CostWeights(),
) -> BatchPlacement:
    """Two-level equivalent of ``replay_on_pack(jp, sp, weights)``: same
    sequential queue/work feedback between rows (written back to the
    pack), same choices and costs, each row resolved through the tier
    bounds instead of a dense (S,) scan."""
    comp_base = comp_site_column(sp, weights).clone()
    comp_min = tp.comp_tier_min(comp_base)
    use32 = _f32_gate(jp, sp, tp, weights)
    # Host mirrors of the fed-back columns (IEEE doubles, the reference's
    # NumPy scalar arithmetic); the device columns get one entry a row.
    cb_h = comp_base.cpu().numpy().copy()
    cm_h = comp_min.cpu().numpy().copy()
    members_h = [m.tolist() for m in tp.members]
    tier_of_h = tp.tier_of.tolist()
    q, w, cap = sp.queue.tolist(), sp.work.tolist(), sp.cap.tolist()
    load_term = (weights.w_load * sp.load).tolist()
    wq, ww = weights.w_queue, weights.w_work
    bytes_, work = jp.bytes_.tolist(), jp.work.tolist()
    J = len(jp.classes)
    site_idx = [0] * J
    costs = [0.0] * J
    for j in range(J):
        col, c = _hier_argmin_row(tp, sp, jp.classes[j], bytes_[j], work[j],
                                  comp_base, comp_min, use32)
        if col < 0:
            raise RuntimeError("no alive site available")
        site_idx[j] = col
        costs[j] = c
        s = col
        q[s] += 1.0
        w[s] += work[j]
        old = cb_h[s]
        # Same elementwise expression as comp_site_column so the value
        # stays bit-identical to a full recomputation (replay_on_pack).
        cb_h[s] = (wq * q[s] / cap[s] + ww * w[s] / cap[s]) + load_term[s]
        comp_base[s] = float(cb_h[s])
        t = tier_of_h[s]
        if cb_h[s] < cm_h[t]:
            cm_h[t] = cb_h[s]
            comp_min[t] = float(cm_h[t])
        elif old == cm_h[t] and cb_h[s] != old:
            # The tier minimum itself moved up: re-aggregate exactly.
            cm_h[t] = cb_h[members_h[t]].min()
            comp_min[t] = float(cm_h[t])
    dev = sp.device
    sp.queue.copy_(torch.as_tensor(q, dtype=_F64, device=dev))
    sp.work.copy_(torch.as_tensor(w, dtype=_F64, device=dev))
    return BatchPlacement(
        site_indices=torch.as_tensor(site_idx, dtype=torch.int64, device=dev),
        sites=[sp.names[i] for i in site_idx],
        costs=torch.as_tensor(costs, dtype=_F64, device=dev),
        classes=jp.classes,
    )
