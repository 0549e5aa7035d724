"""MONARC-style discrete-event grid simulator (paper §XI test-bed).

Five policies are simulated over the same event stream:

  'diana'   — §IV/§V cost-based placement + §X multilevel feedback
              queues + §IX congestion-driven migration
  'greedy'  — submit to the resource with most free slots, no global
              cost view (the strawman in §I)
  'local'   — always run at the submission site, move data to the job
              (MyGrid-style, §III)
  'fcfs'    — one central FCFS queue over all sites (EGEE-WMS-like
              baseline used for comparison in §XI)

Each site has N single-job nodes (§II: a subjob uses one CPU). A job's
wall time on a node = pure work + input fetch (if the dataset is
remote) + output return (if the user is remote) — exactly the cost
structure DIANA optimizes and the baselines ignore.

The port runs on a device (the CUDA card unless ``device="cpu"``): the
dense WAN matrices, the memoized static cost rows, the per-site columns,
the two-level tier aggregates, the reused ``SitePack`` and the migration
planes are float64 tensors there. The event heap, the sites' queues,
the job records and the sequential ``choose_site``/``placement_cost``
path stay Python, as in the reference. Every argmin is NumPy's
(``first_min_index``: first index on ties, the first NaN wins), and a
Python float is divided by a column only as tensor / tensor, so whole
traces equal the reference's bit for bit.
"""
from __future__ import annotations

import heapq
import itertools
import math
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core import (
    Job,
    JobPack,
    MultilevelFeedbackQueues,
    NetworkLink,
    PeerView,
    SitePack,
    SiteState,
    computation_cost,
    network_cost,
    select_peer,
)
from ..core.batch import comp_site_column
from ..core.migration import (
    MigrationDecision,
    apply_migration,
    first_min_index,
    select_peer_targets,
    select_peer_targets_lazy,
)
from .config import _BASE_FIELDS, SimConfig, resolve_config
from .streaming import StreamStats, _ArrivalCursor, as_arrival_source
from .workloads import SimJob

__all__ = ["GridSim", "SimConfig", "SimResult", "uniform_links"]

_F64 = torch.float64


def uniform_links(
    sites: list[str],
    bandwidth_Bps: float = 1e9,
    loss_rate: float = 0.001,
    local_bandwidth_Bps: float = 10e9,
) -> dict[tuple[str, str], NetworkLink]:
    links: dict[tuple[str, str], NetworkLink] = {}
    for a in sites:
        for b in sites:
            if a == b:
                links[(a, b)] = NetworkLink(bandwidth_Bps=local_bandwidth_Bps, loss_rate=0.0)
            else:
                links[(a, b)] = NetworkLink(bandwidth_Bps=bandwidth_Bps, loss_rate=loss_rate)
    return links


@dataclass
class SimResult:
    """One simulation run's outcome — the same type for every entry
    point. ``jobs`` is the caller's list for ``run(list)`` and the
    (usually empty, see ``SimConfig.retain_jobs``) collected list for
    streaming ``ArrivalSource`` runs; ``stats`` is always populated
    with the bounded streaming accumulators, so averages, percentiles
    and makespan survive even when no per-job records are retained."""

    jobs: list[SimJob]
    # site → time-bucket → counters (Fig 9/10/11 series)
    timeline: dict[str, dict[str, list[int]]]
    bucket_s: float
    policy: str
    stats: Optional[StreamStats] = None

    @property
    def avg_queue_time(self) -> float:
        done = [j for j in self.jobs if j.finish >= 0]
        if done:
            return float(np.mean([j.queue_time for j in done]))
        return self.stats.queue_times.mean if self.stats else 0.0

    @property
    def avg_exec_time(self) -> float:
        done = [j for j in self.jobs if j.finish >= 0]
        if done:
            return float(np.mean([j.exec_time for j in done]))
        return self.stats.exec_times.mean if self.stats else 0.0

    @property
    def avg_turnaround(self) -> float:
        done = [j for j in self.jobs if j.finish >= 0]
        if done:
            return float(np.mean([j.turnaround for j in done]))
        return self.stats.turnarounds.mean if self.stats else 0.0

    @property
    def makespan(self) -> float:
        done = [j.finish for j in self.jobs if j.finish >= 0]
        if done:
            return max(done)
        return self.stats.last_finish if self.stats else 0.0

    @property
    def finished(self) -> int:
        n = sum(1 for j in self.jobs if j.finish >= 0)
        if n == 0 and self.stats is not None:
            return self.stats.finished
        return n

    @property
    def throughput(self) -> float:
        m = self.makespan
        return self.finished / m if m > 0 else 0.0

    def migrations(self) -> int:
        n = sum(1 for j in self.jobs if j.migrated)
        if n == 0 and self.stats is not None:
            return self.stats.migrated
        return n

    # -- streaming-safe percentiles (satellite: bounded accumulators) -----
    def queue_time_percentiles(self, qs=(0.5, 0.95, 0.99)) -> list[float]:
        """p50/p95/p99 (by default) queue time from the bounded
        histogram accumulators — available even for million-job
        streaming runs that retained no per-job records."""
        if self.stats is not None and self.stats.finished:
            return [self.stats.queue_times.quantile(q) for q in qs]
        done = [j.queue_time for j in self.jobs if j.finish >= 0]
        return [float(np.quantile(done, q)) for q in qs] if done else [0.0] * len(qs)

    def turnaround_percentiles(self, qs=(0.5, 0.95, 0.99)) -> list[float]:
        if self.stats is not None and self.stats.finished:
            return [self.stats.turnarounds.quantile(q) for q in qs]
        done = [j.turnaround for j in self.jobs if j.finish >= 0]
        return [float(np.quantile(done, q)) for q in qs] if done else [0.0] * len(qs)


class _Site:
    def __init__(self, name: str, nodes: int, quotas: dict[str, float], use_mlfq: bool):
        self.name = name
        self.nodes = nodes
        self.busy = 0
        self.use_mlfq = use_mlfq
        self.mlfq = MultilevelFeedbackQueues(quotas=dict(quotas))
        self.fifo: list[Job] = []
        self.running_work = 0.0
        self.alive = True
        # job_id → Job for every job currently executing here, in
        # dispatch order — a site_down fault kills exactly these.
        self.running: dict[int, Job] = {}

    # queue ops ------------------------------------------------------------
    def enqueue(self, cj: Job, now: float) -> None:
        if self.use_mlfq:
            self.mlfq.submit(cj, now=now)
        else:
            self.fifo.append(cj)

    def pop(self, now: float) -> Optional[Job]:
        if self.use_mlfq:
            return self.mlfq.pop_next(now=now)
        return self.fifo.pop(0) if self.fifo else None

    def queue_len(self) -> int:
        return len(self.mlfq) if self.use_mlfq else len(self.fifo)

    def queued_work(self) -> float:
        jobs = self.mlfq.jobs if self.use_mlfq else self.fifo
        return sum(j.compute_work for j in jobs)

    def state(self) -> SiteState:
        return SiteState(
            name=self.name,
            capacity=float(self.nodes),
            queue_length=float(self.queue_len()),
            waiting_work=self.queued_work() + self.running_work,
            load=self.busy / self.nodes,
            alive=self.alive,
            free_slots=float(self.nodes - self.busy),
        )


class GridSim:
    """Deterministic event-driven simulation of one policy over a grid."""

    # LRU bound on the memoized static cost rows (~4 KB/entry at S=256):
    # arrival batches insert once-used rows; only queued migration
    # candidates re-hit, and evicted rows rebuild vectorized next tick.
    # Per-instance the bound adapts to the site count (rows are O(S)
    # each) so a 1k-site streaming run caps the cache near 128 MB.
    _STATIC_CACHE_MAX = 16_384

    #: SimConfig fields this class accepts as legacy keyword arguments.
    _LEGACY_FIELDS = _BASE_FIELDS

    def __init__(
        self,
        site_nodes: dict[str, int],
        links: Optional[dict[tuple[str, str], NetworkLink]] = None,
        config: Optional[SimConfig] = None,
        *,
        device=None,
        **kw,
    ):
        # ``device`` is the simulator's own keyword, not a SimConfig
        # field: None → the CUDA card (raises when there is none).
        self.device = dev = resolve_device(device)
        cfg = resolve_config(config, kw, self._LEGACY_FIELDS, type(self).__name__)
        assert cfg.policy in ("diana", "greedy", "local", "fcfs")
        if cfg.placement not in ("flat", "hier"):
            raise ValueError(
                f"placement must be 'flat' or 'hier', got {cfg.placement!r}"
            )
        self.config = cfg
        policy = self.policy = cfg.policy
        self._loss: Optional[torch.Tensor] = None  # built on first batch
        self._dense_failed = False                 # partial table: don't retry
        # job-signature → (net, dtc) static cost rows (see _static_cost_rows)
        self._static_row_cache: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
        S = max(1, len(site_nodes))
        self._static_cache_max = min(
            self._STATIC_CACHE_MAX, max(256, int(128e6 / (16 * S)))
        )
        self.links = links or uniform_links(list(site_nodes))
        self.quotas = cfg.quotas or {}
        self.weights = cfg.weights
        self.migration_interval_s = cfg.migration_interval_s
        self.congestion_window_s = cfg.congestion_window_s
        self.bucket_s = cfg.bucket_s
        self.batch_arrivals = cfg.batch_arrivals
        self._batch_arrivals_auto_disabled = False
        self.batch_migration = cfg.batch_migration
        self.sites = {
            name: _Site(name, n, self.quotas, use_mlfq=(policy == "diana"))
            for name, n in site_nodes.items()
        }
        self.central_fifo: deque[Job] = deque()  # fcfs policy only
        self._cj2sj: dict[int, SimJob] = {}
        self._seq = itertools.count()
        self.timeline: dict[str, dict[str, list[int]]] = {
            s: {"submitted": [], "executed": [], "exported": [],
                "imported": [], "requeued": []}
            for s in self.sites
        }
        # Columns in sorted-name order: the first-index argmin tie-break
        # then matches choose_site's (cost, name) tuple sort exactly.
        self._names_sorted = sorted(self.sites)
        self._site_idx = {n: i for i, n in enumerate(self._names_sorted)}
        # Migration evaluates peers in sites-dict order (the sequential
        # PeerView list order), not sorted order: _dict_perm maps dict
        # position → sorted column so the (J, S) planes can be permuted
        # into the order select_peer's stable min walks.
        self._dict_names = list(self.sites)
        self._dict_perm = torch.as_tensor(
            [self._site_idx[n] for n in self._dict_names], dtype=torch.int64, device=dev
        )
        self._dict_pos = {n: i for i, n in enumerate(self._dict_names)}
        self._sp: Optional[SitePack] = None        # reused migration SitePack
        self._sp_dirty: Optional[set[str]] = None  # cols to re-read next tick
        self._mig_prio_cache: dict[str, np.ndarray] = {}
        # Per-site computation-cost value cache (see _comp_base_vec):
        # recomputed-from-state on demand for dirtied columns only —
        # value caching (never incremental float updates) keeps it
        # bit-identical to full recomputation.
        self._cap_vec = torch.as_tensor(
            [float(self.sites[n].nodes) for n in self._names_sorted], dtype=_F64, device=dev
        )
        # Fault-injection state (SimConfig.fault_plan). _alive_vec
        # mirrors the per-site alive bits in sorted-column order;
        # _dead counts down sites so the zero-fault fast paths stay
        # exactly the pre-fault code. _run_token invalidates pending
        # completion events of killed jobs without heap surgery: each
        # dispatch stamps a fresh token into the finish payload and a
        # popped finish whose token is stale is simply dropped.
        self._alive_vec = torch.ones(len(self._names_sorted), dtype=torch.bool, device=dev)
        self._dead = 0
        self._run_token: dict[int, int] = {}
        self._token_seq = itertools.count()
        self._comp_base: Optional[torch.Tensor] = None   # device column
        self._comp_base_h: Optional[np.ndarray] = None   # its host values
        self._comp_ok: Optional[np.ndarray] = None
        self._stats: Optional[StreamStats] = None   # active run's accumulators
        self._collect: Optional[list[SimJob]] = None

    # -- link-table lifecycle -------------------------------------------------
    @property
    def links(self) -> dict[tuple[str, str], NetworkLink]:
        return self._links

    @links.setter
    def links(self, value: dict[tuple[str, str], NetworkLink]) -> None:
        self._links = value
        # A new table is its own pristine state: link faults snapshot
        # lazily on first degradation (see _apply_link_fault).
        self._pristine_links = None
        self.invalidate_links()

    def invalidate_links(self) -> None:
        """Drop every plane derived from the link table (the dense WAN
        matrices and the memoized static cost rows). Call after mutating
        ``links`` in place; assigning a new table does it automatically.
        A fast path disabled by an earlier partial table gets another
        chance against the new one."""
        self._loss = None
        self._bw = self._eff = None
        self._static_row_cache.clear()
        self._dense_failed = False
        # The two-level placement aggregates are derived from the same
        # dense matrices, so they fall with them (rebuilt lazily).
        self._h_perm = None
        self._h_tier_cols = None
        self._h_tier_cols_h = None
        self._h_pad = self._h_padmask = None
        self._h_tier_of = None
        self._h_net_tmin = None
        self._h_effin_tmax = None
        self._h_effout_tmax = None
        self._h_ok = False
        # Re-enable the arrival fast path only if the old table's
        # partialness disabled it (never override a user's own setting).
        if getattr(self, "_batch_arrivals_auto_disabled", False):
            self._batch_arrivals_auto_disabled = False
            self.batch_arrivals = True

    def _link_matrices_ready(self) -> bool:
        """Build the dense WAN-link matrices for the arrival-batch fast
        path on first use. A partial link table (only the pairs the
        sequential path happens to traverse) can't be densified — then
        the fast path is disabled and arrivals fall back to the
        sequential handler instead of crashing previously-valid setups."""
        if self._loss is not None:
            return True
        if self._dense_failed:          # known-partial: don't rescan S²
            return False
        S = len(self._names_sorted)
        loss = np.empty((S, S))
        bw = np.empty((S, S))
        eff = np.empty((S, S))
        try:
            for a, na in enumerate(self._names_sorted):
                for b, nb in enumerate(self._names_sorted):
                    link = self.links[(na, nb)]
                    loss[a, b] = link.loss_rate
                    bw[a, b] = link.bandwidth_Bps
                    eff[a, b] = link.effective_bandwidth()
        except KeyError:
            if self.batch_arrivals:
                self.batch_arrivals = False
                self._batch_arrivals_auto_disabled = True
            self._dense_failed = True
            return False
        # One host→device copy per matrix.
        self._loss, self._bw, self._eff = (
            torch.from_numpy(m).to(self.device) for m in (loss, bw, eff)
        )
        return True

    # -- cost model (§IV on simulator state) --------------------------------
    def _eff_bw(self, a: str, b: str) -> float:
        return self.links[(a, b)].effective_bandwidth()

    def _static_terms(self, sj: SimJob, site: str) -> tuple[float, float]:
        """The job-constant §IV terms (net, dtc) of ``placement_cost``
        — the single scalar source of the formula (P2P placement swaps
        only the computation term, so it must share these)."""
        net = network_cost(self.links[(sj.origin_site, site)])
        dtc = 0.0
        if sj.data_site is not None and sj.data_site != site:
            dtc += sj.input_bytes / self._eff_bw(sj.data_site, site)
        if sj.origin_site != site:
            dtc += sj.output_bytes / self._eff_bw(site, sj.origin_site)
        return net, dtc

    def placement_cost(self, sj: SimJob, site: str) -> float:
        st = self.sites[site].state()
        net, dtc = self._static_terms(sj, site)
        comp = computation_cost(st, self.weights) + sj.work / st.capacity
        return net + comp + dtc

    def _service_seconds(self, sj: SimJob, site: str) -> float:
        dur = sj.work
        if sj.data_site is not None and sj.data_site != site:
            dur += sj.input_bytes / self._eff_bw(sj.data_site, site)
        if sj.origin_site != site:
            dur += sj.output_bytes / self._eff_bw(site, sj.origin_site)
        return dur

    # -- placement policies --------------------------------------------------
    def choose_site(self, sj: SimJob) -> str:
        if self.policy == "local":
            # Dead origin sites bounce in _admit (the job is redirected
            # through the §IX failover path, not silently re-homed).
            return sj.origin_site
        if self.policy == "greedy":
            pool = (
                [s for s in self.sites.values() if s.alive]
                if self._dead else self.sites.values()
            )
            if not pool:
                raise RuntimeError("no alive site available")
            return max(
                pool,
                key=lambda s: (s.nodes - s.busy - s.queue_len(), s.nodes),
            ).name
        # diana — §V: ascending total cost, first alive site.
        costs = sorted(
            (self.placement_cost(sj, name), name)
            for name in self.sites
            if not self._dead or self.sites[name].alive
        )
        if not costs:
            raise RuntimeError("no alive site available")
        return costs[0][1]

    # -- batched §IV evaluation (arrival-batch fast path) ---------------------
    def _batch_eligible(self, batch: list[SimJob]) -> bool:
        """The dense fast path needs a full link table AND every job
        endpoint to be a grid site; jobs whose data/origin lives on a
        link-table-only node (e.g. a storage element) go through the
        sequential handler, which indexes links by tuple directly."""
        if self.policy != "diana" or not self._link_matrices_ready():
            return False
        idx = self._site_idx
        return all(
            sj.origin_site in idx
            and (sj.data_site is None or sj.data_site in idx)
            for sj in batch
        )

    @staticmethod
    def _static_sig(sj: SimJob) -> tuple:
        """Memoization key for the per-job-constant (net, dtc) rows:
        everything ``placement_cost`` reads besides live site state."""
        return (sj.origin_site, sj.data_site, sj.input_bytes, sj.output_bytes)

    def _static_cost_rows(self, batch: list[SimJob]) -> tuple[torch.Tensor, torch.Tensor]:
        """(net, dtc) rows of ``placement_cost`` over sorted-site columns
        for a batch of jobs, as (B, S) tensors on the sim's device — the
        per-job-constant terms, memoized by job signature. Each row
        depends only on its own job (the evaluation is elementwise per
        row), so rows cached from earlier batches are bit-identical to
        recomputing them; the migration pass re-evaluates the same
        congested jobs every tick and hits the cache.
        ``invalidate_links`` clears it."""
        if not self._link_matrices_ready():
            raise KeyError("link table is partial; dense matrices unavailable")
        net: list = [None] * len(batch)
        dtc: list = [None] * len(batch)
        miss: list[SimJob] = []
        miss_rows: list[list[int]] = []
        pending: dict[tuple, int] = {}  # bulk bursts share one signature
        cache = self._static_row_cache
        for i, sj in enumerate(batch):
            sig = self._static_sig(sj)
            hit = cache.pop(sig, None)
            if hit is not None:
                cache[sig] = hit        # re-insert: LRU order via dict
                net[i], dtc[i] = hit
                continue
            k = pending.get(sig)
            if k is None:
                pending[sig] = len(miss)
                miss.append(sj)
                miss_rows.append([i])
            else:
                miss_rows[k].append(i)
        if miss:
            # Cached rows are views of one (M, S) tensor per batch of
            # misses; the returned planes are fresh stacks of them.
            mnet, mdtc = self._compute_static_rows(miss)
            for k, (rn, rd) in enumerate(zip(mnet.unbind(0), mdtc.unbind(0))):
                cache[self._static_sig(miss[k])] = (rn, rd)
                for i in miss_rows[k]:
                    net[i], dtc[i] = rn, rd
            while len(cache) > self._static_cache_max:
                cache.pop(next(iter(cache)))
        if not batch:
            empty = torch.empty((0, len(self._names_sorted)), dtype=_F64, device=self.device)
            return empty, empty.clone()
        return torch.stack(net), torch.stack(dtc)

    def _compute_static_rows(self, batch: list[SimJob]) -> tuple[torch.Tensor, torch.Tensor]:
        """Uncached (net, dtc) rows, vectorized over the dense WAN-link
        matrices."""
        S = len(self._names_sorted)
        dev = self.device
        idx = self._site_idx
        o = torch.as_tensor([idx[sj.origin_site] for sj in batch], device=dev)
        net = (self._loss[o, :] / self._bw[o, :]) * 1.0e6
        cols = torch.arange(S, device=dev)[None, :]
        inb = torch.as_tensor([sj.input_bytes for sj in batch], dtype=_F64, device=dev)
        outb = torch.as_tensor([sj.output_bytes for sj in batch], dtype=_F64, device=dev)
        has_data = torch.as_tensor([sj.data_site is not None for sj in batch], device=dev)
        d = torch.as_tensor(
            [idx[sj.data_site] if sj.data_site is not None else 0 for sj in batch], device=dev
        )
        in_term = torch.where(
            has_data[:, None] & (d[:, None] != cols), inb[:, None] / self._eff[d, :], 0.0,
        )
        out_term = torch.where(
            o[:, None] != cols, outb[:, None] / self._eff[:, o].T, 0.0
        )
        return net, in_term + out_term

    def _dirty_site(self, name: str) -> None:
        """Invalidate the cached per-site derived values after any
        mutation of that site's queue/busy/running state. Every mutation
        path (_admit enqueue, _start, _on_finish, migration moves) calls
        this; the batch-vs-sequential equivalence suites double as
        invalidation-completeness tests."""
        ok = self._comp_ok
        if ok is not None:
            ok[self._site_idx[name]] = False
        sd = self._sp_dirty
        if sd is not None:
            sd.add(name)

    def _comp_base_vec(self) -> torch.Tensor:
        """Per-site ``computation_cost(state())`` column over sorted-name
        order, value-cached with dirty invalidation.

        Cached entries are *recomputed from fresh state* whenever their
        site was touched — never incrementally updated — so each value
        is the exact float the sequential path's ``placement_cost``
        computes. The values are computed on the host (from the Python
        site state) and reach the device column in one copy."""
        base, ok = self._comp_base, self._comp_ok
        if base is None:
            S = len(self._names_sorted)
            base = self._comp_base = torch.empty(S, dtype=_F64, device=self.device)
            self._comp_base_h = np.empty(S)
            ok = self._comp_ok = np.zeros(S, bool)
        if not ok.all():
            host = self._comp_base_h
            for i in np.flatnonzero(~ok):
                st = self.sites[self._names_sorted[i]].state()
                host[i] = computation_cost(st, self.weights)
            ok[:] = True
            base.copy_(torch.from_numpy(host))
        return base

    def _comp_vec(self, sj: SimJob) -> torch.Tensor:
        """Live computation-cost column (the only term arrivals mutate):
        the dirty-cached per-site base plus this job's work/capacity
        row — elementwise the same two-term addition as the sequential
        path's ``placement_cost`` (bit-identical)."""
        cap = self._cap_vec
        out = self._comp_base_vec() + torch.full_like(cap, sj.work) / cap
        if self._dead:
            # Poison dead columns: +inf propagates through the cost
            # sum, so argmin lands on the cheapest alive site — the
            # same site the filtered sequential sort selects.
            out = torch.where(self._alive_vec, out, math.inf)
        return out

    # -- two-level placement (config.placement == "hier") ---------------------
    def _hier_ready(self) -> bool:
        """True when the two-level tier-bound pick may replace the flat
        row argmin: hier placement requested, diana policy, dense WAN
        matrices available, and the tier aggregates built (lazily) from
        a sane table (finite network terms, positive effective
        bandwidths — the preconditions of the bound algebra)."""
        if self.config.placement != "hier" or self.policy != "diana":
            return False
        if not self._link_matrices_ready():
            return False
        if self._h_perm is None:
            self._build_hier_structs()
        return self._h_ok

    def _build_hier_structs(self) -> None:
        """Static per-origin tier aggregates over the dense matrices.

        One tier = one RootGrid of ``config.topology`` (no topology =
        one tier over the whole grid; off-topology sites become
        singleton tiers via ``tier_of``). Per origin (and per data
        site) the aggregates give admissible §IV lower bounds:

          net_tmin[o, t]     min over s∈t of the network term from o
          effin_tmax[d, t]   max over s∈t of eff(d→s): divides into a
                             lower bound on the input-fetch term
          effout_tmax[o, t]  max over s∈t of eff(s→o): same for the
                             output-return term

        Members within a tier are kept in ascending sorted-column
        order, so a within-tier argmin's first-index tie-break is the
        lowest global column of that tier — the cross-tier (cost, col)
        walk in ``_hier_pick`` then reproduces the flat argmin's
        global first-index tie-break exactly. The reference's
        ``np.minimum.reduceat`` over the tier permutation is a min over
        a (T, L) padded member table here: a min is exact in any order."""
        names = self._names_sorted
        topo = self.config.topology
        if topo is not None:
            members = topo.tier_members(names)
        else:
            members = {"grid": list(names)}
        labels = sorted(members)
        idx = self._site_idx
        dev = self.device
        tier_cols = [[idx[n] for n in members[lab]] for lab in labels]
        L = max(len(c) for c in tier_cols)
        self._h_perm = torch.as_tensor([c for cols in tier_cols for c in cols],
                                       dtype=torch.int64, device=dev)
        self._h_tier_cols = [torch.as_tensor(c, dtype=torch.int64, device=dev) for c in tier_cols]
        self._h_tier_cols_h = tier_cols
        self._h_pad = torch.as_tensor([c + [c[0]] * (L - len(c)) for c in tier_cols],
                                      dtype=torch.int64, device=dev)
        self._h_padmask = torch.as_tensor(
            [[False] * len(c) + [True] * (L - len(c)) for c in tier_cols], device=dev)
        tier_of = [0] * len(names)
        for t, cols in enumerate(tier_cols):
            for c in cols:
                tier_of[c] = t
        self._h_tier_of = tier_of
        pad, padm = self._h_pad, self._h_padmask
        net_all = (self._loss / self._bw) * 1.0e6      # net[o, s]
        self._h_net_tmin = net_all[:, pad].masked_fill(padm, math.inf).amin(dim=2)
        self._h_effin_tmax = self._eff[:, pad].masked_fill(padm, -math.inf).amax(dim=2)
        self._h_effout_tmax = self._eff.T[:, pad].masked_fill(padm, -math.inf).amax(dim=2)
        # Bound admissibility needs finite network terms and positive
        # effective bandwidths (division by a tier-max is only a lower
        # bound for a positive, monotone divisor). A degenerate table
        # keeps hier off and the flat path bit-exact by construction.
        self._h_ok = bool(torch.isfinite(net_all).all() & (self._eff > 0.0).all())

    def _hier_pick(self, sj: SimJob, comp: torch.Tensor,
                   net_row: torch.Tensor, dtc_row: torch.Tensor) -> int:
        """Two-level argmin over one job's §IV row — bit-identical to
        ``int(first_min_index((net_row + comp) + dtc_row))``.

        Tiers are ranked by an admissible lower bound (each §IV term
        bounded independently; fp addition is monotone, and a relative
        round-down guard absorbs the bound's own rounding), then the
        exact row is evaluated only on tiers whose bound can still beat
        the best cost seen. Ties widen: a tier whose bound *equals* the
        current best is still refined, and the (cost, column) walk
        keeps the lowest column among equal minima — the flat argmin's
        first-index rule across tier boundaries. One readback a row
        (the ranked bounds) and one a refined tier."""
        def flat() -> int:
            return int(first_min_index((net_row + comp) + dtc_row))

        inb, outb = sj.input_bytes, sj.output_bytes
        if not (inb >= 0.0 and outb >= 0.0):
            # Negative/NaN byte counts break the division-monotonicity
            # argument; the degenerate flat row is the spec.
            return flat()
        o = self._site_idx[sj.origin_site]
        T = len(self._h_tier_cols)
        comp_tmin = comp[self._h_pad].masked_fill(self._h_padmask, math.inf).amin(dim=1)
        if sj.data_site is not None and inb > 0.0:
            d = self._site_idx[sj.data_site]
            eff = self._h_effin_tmax[d]
            in_lb = torch.full_like(eff, inb) / eff
            in_lb[self._h_tier_of[d]] = 0.0     # s == data site ⇒ no fetch
        else:
            in_lb = torch.zeros(T, dtype=_F64, device=self.device)
        if outb > 0.0:
            eff = self._h_effout_tmax[o]
            out_lb = torch.full_like(eff, outb) / eff
            out_lb[self._h_tier_of[o]] = 0.0    # s == origin ⇒ no return
        else:
            out_lb = torch.zeros(T, dtype=_F64, device=self.device)
        bound = (self._h_net_tmin[o] + comp_tmin) + (in_lb + out_lb)
        bound = torch.where(torch.isnan(bound), -math.inf, bound)   # unknown ⇒ always refine
        bound = torch.where(torch.isfinite(bound), bound - bound.abs() * 1e-12, bound)
        order = torch.argsort(bound, stable=True)
        bound_h, order_h = torch.stack((bound, order.to(_F64))).tolist()
        best_cost = math.inf
        best_col = -1
        for t in order_h:
            t = int(t)
            if bound_h[t] > best_cost:
                break
            cols = self._h_tier_cols[t]
            row = (net_row[cols] + comp[cols]) + dtc_row[cols]
            k = first_min_index(row)
            k, c = torch.stack((k.to(_F64), row[k])).tolist()
            if math.isnan(c):
                # A NaN row entry wins the flat argmin; reproduce that
                # verdict exactly via the full row.
                return flat()
            col = self._h_tier_cols_h[t][int(k)]
            if c < best_cost or (c == best_cost and col < best_col):
                best_cost = c
                best_col = col
        if best_col < 0:
            # Every tier refined to +inf (all sites poisoned): the flat
            # argmin of an all-inf row answers column 0.
            return flat()
        return best_col

    def choose_sites_batch(self, batch: list[SimJob]) -> list[str]:
        """Vectorized ``choose_site`` over a batch against the current
        state snapshot (no admissions in between) — equivalent to
        ``[self.choose_site(sj) for sj in batch]`` with untouched state.
        The event loop's fast path (``_on_arrive_batch``) interleaves
        the same evaluation with admissions instead."""
        if not self._batch_eligible(batch):
            return [self.choose_site(sj) for sj in batch]
        net, dtc = self._static_cost_rows(batch)
        # State is frozen here, so the job-independent computation base
        # is computed once; adding sj.work/cap per row keeps the same
        # two-term addition as placement_cost (bit-identical).
        base = torch.as_tensor(
            [computation_cost(self.sites[n].state(), self.weights)
             for n in self._names_sorted], dtype=_F64, device=self.device,
        )
        if self._dead:
            base = torch.where(self._alive_vec, base, math.inf)
        cap = torch.as_tensor([float(self.sites[n].nodes) for n in self._names_sorted],
                              dtype=_F64, device=self.device)
        rows = [base + torch.full_like(cap, sj.work) / cap for sj in batch]
        if self._hier_ready():
            return [
                self._names_sorted[self._hier_pick(sj, rows[i], net[i], dtc[i])]
                for i, sj in enumerate(batch)
            ]
        picks = first_min_index((net + torch.stack(rows)) + dtc).tolist()
        return [self._names_sorted[k] for k in picks]

    # -- simulation ------------------------------------------------------------
    def run(self, jobs, until: Optional[float] = None) -> SimResult:
        """Simulate one workload to completion (or ``until``).

        ``jobs`` is either a materialized ``list[SimJob]`` (the classic
        entry point — the returned ``SimResult.jobs`` is that same
        list) or any lazy ``ArrivalSource`` (an object with
        ``chunks()``), in which case jobs are generated, placed and
        retired incrementally with bounded in-flight state and the
        result carries only the streaming accumulators (unless
        ``SimConfig.retain_jobs``). Both entry points and both loop
        implementations (``horizon`` on/off) produce bit-identical
        results on the same workload.
        """
        source = as_arrival_source(jobs)
        input_list = jobs if isinstance(jobs, list) else None
        horizon_t = until if until is not None else float("inf")
        plan = self.config.fault_plan
        if plan is not None:
            plan.validate(
                sites=set(self.sites),
                num_peers=getattr(self, "num_peers", None),
            )
        # Every run replays its fault plan from a clean slate (and a
        # previous truncated run must not leak liveness/link damage
        # into a plain re-run either).
        self._reset_faults()
        self._stats = StreamStats()
        # Derived-value caches never survive into a run: the caller may
        # have mutated site state between runs.
        self._comp_base = self._comp_ok = None
        self._sp = None
        self._sp_dirty = None
        self._collect = [] if input_list is None and self.config.retain_jobs else None
        cursor = _ArrivalCursor(source.chunks())
        self._on_stream_start(cursor.peek_time())
        if self.config.horizon:
            self._run_horizon(cursor, horizon_t)
            out_jobs = input_list if input_list is not None else (self._collect or [])
        else:
            materialized = input_list if input_list is not None else cursor.drain()
            self._run_events(materialized, horizon_t)
            out_jobs = materialized if (
                input_list is not None or self.config.retain_jobs
            ) else []
        stats, self._stats, self._collect = self._stats, None, None
        return SimResult(
            jobs=out_jobs, timeline=self.timeline, bucket_s=self.bucket_s,
            policy=self.policy, stats=stats,
        )

    def _on_stream_start(self, t0: float) -> None:
        """Hook invoked once per run with the first arrival timestamp
        (``inf`` for an empty workload) — P2PGridSim seeds its peers'
        bootstrap stamps here."""

    def _run_events(self, jobs: list[SimJob], horizon: float) -> None:
        """The per-event reference loop: one heap pop per event, exactly
        the pre-horizon semantics. Arrivals are heap-seeded up front
        (their seqs are the lowest, so at equal timestamps arrivals
        always precede completions/migration/exchange)."""
        events: list[tuple[float, int, str, object]] = []
        for sj in jobs:
            heapq.heappush(events, (sj.arrival, next(self._seq), "arrive", sj))
        self._seed_faults(events)
        if self.policy == "diana" and jobs:
            t0 = min(j.arrival for j in jobs)
            heapq.heappush(
                events,
                (t0 + self.migration_interval_s, next(self._seq), "migrate", None),
            )
            if getattr(self, "exchange_interval_s", None):
                heapq.heappush(
                    events,
                    (t0 + self.exchange_interval_s, next(self._seq), "exchange", None),
                )

        while events:
            now, _, kind, payload = heapq.heappop(events)
            if now > horizon:
                break
            if kind == "arrive":
                # Same-instant arrivals pop consecutively (their seqs are
                # the lowest at that timestamp), so draining them here is
                # order-identical to one-at-a-time processing.
                if self.batch_arrivals and self.policy == "diana":
                    batch = [payload]
                    while events and events[0][0] == now and events[0][2] == "arrive":
                        batch.append(heapq.heappop(events)[3])
                    if len(batch) > 1 and self._batch_eligible(batch):
                        self._on_arrive_batch(batch, now, events)
                    else:
                        for sj in batch:
                            self._on_arrive(sj, now, events)
                else:
                    self._on_arrive(payload, now, events)
            elif kind == "finish":
                site_name, cj, tok = payload
                self._on_finish(site_name, cj, tok, now, events)
            elif kind == "fault":
                self._on_fault(payload, now, events)
            elif kind == "migrate":
                self._on_migrate_check(now, events)
                if self._work_remaining(events):
                    heapq.heappush(
                        events,
                        (now + self.migration_interval_s, next(self._seq), "migrate", None),
                    )
            elif kind == "exchange":
                # Multi-scheduler mode only (P2PGridSim): a peer
                # advertisement round, rescheduled while work remains
                # (in-flight adverts drain via "deliver" events, so they
                # must NOT keep the exchange alive — each round sends
                # new ones and the sim would never terminate).
                self._on_exchange(now, events)
                if self._work_remaining(events):
                    heapq.heappush(
                        events,
                        (now + self.exchange_interval_s, next(self._seq), "exchange", None),
                    )
            elif kind == "deliver":
                self._on_deliver(now, events)

    def _run_horizon(self, cursor: _ArrivalCursor, horizon: float) -> None:
        """The batched event-horizon loop.

        Arrivals live in the lazy ``cursor`` (never in the heap — a 1M
        job stream costs no heap memory); the heap holds only
        completions and the periodic migrate/exchange/deliver events.
        Each iteration advances to ``min(next arrival, heap top)``:

        * arrivals first at equal timestamps (in the per-event loop
          every arrival's seq is lower than any later-pushed event's),
          draining the whole same-instant run — or, with
          ``horizon_eps_s``, the whole epsilon window — into one
          ``_on_arrive_batch`` (J, S) pass;
        * consecutive same-instant completions drain in one heap pass
          (strictly in seq order — each finish still applies its own
          bookkeeping + dispatch so float op order matches the
          reference loop bit-for-bit);
        * migrate/exchange/deliver behave exactly as in the per-event
          loop, with "arrivals still to come" read from the cursor.

        With ``horizon_eps_s == 0`` the schedule is bit-identical to
        ``_run_events`` (equivalence-tested for GridSim and P2PGridSim).
        """
        inf = float("inf")
        eps = float(self.config.horizon_eps_s)
        events: list[tuple[float, int, str, object]] = []
        # Fault events are seeded up front in both loops, so their seqs
        # are below every runtime-pushed finish: at equal timestamps a
        # fault pops before the finishes it is about to invalidate —
        # identically here and in the reference loop (the same-instant
        # finish drain below stops when a fault reaches the heap top).
        self._seed_faults(events)
        t0 = cursor.peek_time()
        if self.policy == "diana" and t0 != inf:
            heapq.heappush(
                events,
                (t0 + self.migration_interval_s, next(self._seq), "migrate", None),
            )
            if getattr(self, "exchange_interval_s", None):
                heapq.heappush(
                    events,
                    (t0 + self.exchange_interval_s, next(self._seq), "exchange", None),
                )

        while True:
            ta = cursor.peek_time()
            te = events[0][0] if events else inf
            now = min(ta, te)
            if now == inf or now > horizon:
                break
            if ta <= te:
                hi = min(ta + eps, horizon) if eps > 0.0 else ta
                self._process_arrivals(cursor.pop_until(hi), ta, events)
                continue
            now, _, kind, payload = heapq.heappop(events)
            if kind == "finish":
                site_name, cj, tok = payload
                self._on_finish(site_name, cj, tok, now, events)
                # Drain the consecutive same-instant completion run
                # (bulk bursts finish together) without bouncing through
                # the cursor comparison per event. Strictly in heap
                # order: a zero-duration dispatch can push a new finish
                # at `now`, and an interleaved migrate/exchange/fault
                # event ends the run exactly as it would end the pop
                # sequence.
                while events and events[0][0] == now and events[0][2] == "finish":
                    _, _, _, (sn, fcj, ftok) = heapq.heappop(events)
                    self._on_finish(sn, fcj, ftok, now, events)
            elif kind == "fault":
                self._on_fault(payload, now, events)
            elif kind == "migrate":
                self._on_migrate_check(now, events)
                if self._stream_work_remaining(cursor):
                    heapq.heappush(
                        events,
                        (now + self.migration_interval_s, next(self._seq), "migrate", None),
                    )
            elif kind == "exchange":
                self._on_exchange(now, events)
                if self._stream_work_remaining(cursor):
                    heapq.heappush(
                        events,
                        (now + self.exchange_interval_s, next(self._seq), "exchange", None),
                    )
            elif kind == "deliver":
                self._on_deliver(now, events)

    def _process_arrivals(self, batch: list[SimJob], now: float, events: list) -> None:
        """Admit one drained arrival batch (same-instant, or one eps
        window). Unlike the per-event loop, eligible single-job batches
        also take the vectorized path — it is bit-identical to
        ``choose_site`` per row, and open-loop Poisson streams are
        almost entirely single arrivals."""
        if not batch:
            return
        if (
            self.batch_arrivals
            and self.policy == "diana"
            and self._batch_eligible(batch)
        ):
            self._on_arrive_batch(batch, now, events)
        else:
            for sj in batch:
                self._on_arrive(sj, now, events)

    def _work_remaining(self, events: list) -> bool:
        """Whether the periodic events (migrate/exchange) should keep
        rescheduling: queued jobs anywhere, or arrivals still to come.
        One predicate for both so they always stop together."""
        return any(s.queue_len() for s in self.sites.values()) or any(
            e[2] == "arrive" for e in events
        )

    def _stream_work_remaining(self, cursor: _ArrivalCursor) -> bool:
        """``_work_remaining`` for the horizon loop: pending arrivals
        live in the cursor, not the heap. Equivalent predicate — in
        both loops an arrival pending at decision time is strictly in
        the future."""
        return any(s.queue_len() for s in self.sites.values()) or (
            cursor.peek_time() != float("inf")
        )

    # -- multi-scheduler hooks (no-ops in the omniscient base sim) -----------
    #: §IX trust horizon: peers whose advertised rows are older than this
    #: are not polled for migration (P2PGridSim overrides the staleness).
    migration_max_staleness_s = float("inf")

    def _on_exchange(self, now: float, events: list) -> None:
        """Peer advertisement round (P2PGridSim)."""

    def _on_deliver(self, now: float, events: list) -> None:
        """Latency-delayed advert delivery (P2PGridSim)."""

    def _migration_staleness(self, name: str, now: float) -> Optional[torch.Tensor]:
        """Per-column (sorted-name order) age of the deciding
        scheduler's world view, on the sim's device; None = omniscient
        (zero staleness)."""
        return None

    # -- handlers ------------------------------------------------------------
    def _bucket(self, site: str, key: str, now: float) -> None:
        series = self.timeline[site][key]
        idx = int(now / self.bucket_s)
        while len(series) <= idx:
            series.append(0)
        series[idx] += 1

    def _on_arrive(self, sj: SimJob, now: float, events: list) -> None:
        self._admit(sj, self.choose_site(sj), now, events)

    def _on_arrive_batch(self, batch: list[SimJob], now: float, events: list) -> None:
        """Arrival-batch fast path (§VIII bulk bursts): the static
        network + data-transfer planes are evaluated once for the whole
        same-instant batch; per job only the computation term is
        re-read from live site state, so placements are bit-identical
        to sequential ``_on_arrive`` calls."""
        net, dtc = self._static_cost_rows(batch)
        if self._hier_ready():
            for i, sj in enumerate(batch):
                k = self._hier_pick(sj, self._comp_vec(sj), net[i], dtc[i])
                self._admit(sj, self._names_sorted[k], now, events)
            return
        for i, sj in enumerate(batch):
            row = (net[i] + self._comp_vec(sj)) + dtc[i]
            self._admit(sj, self._names_sorted[int(first_min_index(row))], now, events)

    def _admit(self, sj: SimJob, target: str, now: float, events: list) -> str:
        if self.policy != "fcfs" and not self.sites[target].alive:
            # A stale-view submission (P2P) or dead-origin local job
            # aimed at a down site: the authoritative grid bounces it
            # to the cheapest alive site. Returns the final target so
            # the caller's optimistic bookkeeping follows the job.
            target = self._failover_target(sj)
            sj.requeues += 1
            if self._stats is not None:
                self._stats.on_redirect()
        sj.exec_site = target
        sj.queue_enter = now
        cj = Job(
            user=sj.user, t=sj.t, submit_time=now, compute_work=sj.work,
            input_bytes=sj.input_bytes, output_bytes=sj.output_bytes,
            group_id=sj.group_id,
        )
        self._cj2sj[cj.job_id] = sj
        if self._stats is not None:
            self._stats.on_admit(sj, len(self._cj2sj))
        if self._collect is not None:
            self._collect.append(sj)
        self._bucket(target, "submitted", now)
        if self.policy == "fcfs":
            self.central_fifo.append(cj)
            self._dispatch_central(now, events)
        else:
            self.sites[target].enqueue(cj, now)
            self._dirty_site(target)
            self._dispatch(target, now, events)
        return target

    def _start(self, site: _Site, cj: Job, now: float, events: list) -> None:
        sj = self._cj2sj[cj.job_id]
        sj.start = now
        dur = self._service_seconds(sj, site.name)
        sj.finish = now + dur
        site.busy += 1
        site.running_work += sj.work
        site.running[cj.job_id] = cj
        tok = next(self._token_seq)
        self._run_token[cj.job_id] = tok
        self._dirty_site(site.name)
        heapq.heappush(
            events, (sj.finish, next(self._seq), "finish", (site.name, cj, tok))
        )

    def _dispatch(self, site_name: str, now: float, events: list) -> None:
        site = self.sites[site_name]
        if not site.alive:
            return
        while site.busy < site.nodes:
            cj = site.pop(now)
            if cj is None:
                return
            self._start(site, cj, now, events)

    def _dispatch_central(self, now: float, events: list) -> None:
        while self.central_fifo:
            free = [s for s in self.sites.values() if s.alive and s.busy < s.nodes]
            if not free:
                return
            cj = self.central_fifo.popleft()
            site = free[0]
            self._cj2sj[cj.job_id].exec_site = site.name
            self._start(site, cj, now, events)

    def _on_finish(
        self, site_name: str, cj: Job, tok: int, now: float, events: list
    ) -> None:
        if self._run_token.get(cj.job_id) != tok:
            # Stale completion: the job's site died and the job was
            # requeued (and possibly redispatched with a fresh token)
            # after this event was scheduled. Drop it.
            return
        del self._run_token[cj.job_id]
        site = self.sites[site_name]
        if not site.alive:
            raise AssertionError(
                f"job {cj.job_id} completed on dead site {site_name!r} — "
                f"fault bookkeeping failed to invalidate its finish event"
            )
        site.busy -= 1
        site.running_work -= cj.compute_work
        site.running.pop(cj.job_id, None)
        self._dirty_site(site_name)
        self._bucket(site_name, "executed", now)
        self._finalize(cj)
        if self.policy == "fcfs":
            self._dispatch_central(now, events)
        else:
            self._dispatch(site_name, now, events)

    def _finalize(self, cj: Job) -> None:
        """Retire one completed job: feed the streaming accumulators
        and drop its in-flight mapping (bounded state — no reference
        to a finished job's Job/SimJob pair survives unless the caller
        holds the list)."""
        sj = self._cj2sj.pop(cj.job_id, None)
        if sj is not None and self._stats is not None:
            self._stats.on_finish(sj)

    # -- fault injection (SimConfig.fault_plan) -------------------------------
    def _seed_faults(self, events: list) -> None:
        """Push the plan's events into the heap before any runtime
        event allocates a seq: at equal timestamps faults then order
        after arrivals (whose seqs are lower still) and before every
        finish/migrate/exchange — identically in both run loops."""
        plan = self.config.fault_plan
        if plan is None:
            return
        for ev in plan.sorted_events():
            heapq.heappush(events, (ev.time, next(self._seq), "fault", ev))

    def _on_fault(self, ev, now: float, events: list) -> None:
        if ev.kind == "site_down":
            self._fail_site(ev.site, now, events)
        elif ev.kind == "site_up":
            self._recover_site(ev.site, now, events)
        elif ev.kind in ("link_degrade", "link_restore"):
            self._apply_link_fault(ev)
        else:
            # peer_leave/peer_join — P2PGridSim overrides; run() has
            # already validated plans, so this is a defensive backstop.
            raise ValueError(
                f"fault kind {ev.kind!r} requires the multi-scheduler "
                f"P2PGridSim"
            )

    def _failover_target(self, sj: SimJob) -> str:
        """Re-place one displaced/redirected job over the alive sites:
        greedy keeps its free-slot rule; every other policy takes the
        §IX route — cheapest alive site by the full §IV cost."""
        alive = [n for n in self.sites if self.sites[n].alive]
        if not alive:
            raise RuntimeError("no alive site available")
        if self.policy == "greedy":
            return max(
                (self.sites[n] for n in alive),
                key=lambda s: (s.nodes - s.busy - s.queue_len(), s.nodes),
            ).name
        return min((self.placement_cost(sj, n), n) for n in alive)[1]

    def _fail_site(self, name: str, now: float, events: list) -> None:
        site = self.sites[name]
        if not site.alive:
            return
        site.alive = False
        self._alive_vec[self._site_idx[name]] = False
        self._dead += 1
        # Kill running jobs (their pending finish events go stale via
        # the run-token check), then drain the queue; displaced jobs
        # re-enter placement in dispatch order then queue order.
        displaced: list[Job] = []
        for jid, cj in list(site.running.items()):
            del site.running[jid]
            self._run_token.pop(jid, None)
            site.busy -= 1
            site.running_work -= cj.compute_work
            sj = self._cj2sj[cj.job_id]
            sj.start = sj.finish = -1.0
            displaced.append(cj)
        if site.use_mlfq:
            for cj in list(site.mlfq.jobs):
                site.mlfq.remove(cj)
                displaced.append(cj)
        else:
            drained, site.fifo = site.fifo, []
            displaced.extend(drained)
        self._dirty_site(name)
        for cj in displaced:
            self._requeue(cj, name, now, events)

    def _requeue(self, cj: Job, from_site: str, now: float, events: list) -> None:
        """Re-place one job displaced by a site death — the §IX
        migration path over the alive sites (fcfs jobs simply rejoin
        the central queue). The job is NOT pinned: a genuine §IX
        migration later may still move it once."""
        sj = self._cj2sj[cj.job_id]
        sj.requeues += 1
        if self._stats is not None:
            self._stats.on_requeue()
        self._bucket(from_site, "requeued", now)
        if self.policy == "fcfs":
            self.central_fifo.append(cj)
            self._dispatch_central(now, events)
            return
        target = self._failover_target(sj)
        sj.exec_site = target
        self.sites[target].enqueue(cj, now)
        self._dirty_site(target)
        self._dispatch(target, now, events)

    def _recover_site(self, name: str, now: float, events: list) -> None:
        site = self.sites[name]
        if site.alive:
            return
        site.alive = True
        self._alive_vec[self._site_idx[name]] = True
        self._dead -= 1
        self._dirty_site(name)
        if self.policy == "fcfs":
            # The revived capacity may unblock the central queue; other
            # policies re-route at the next arrival/migration tick (the
            # site comes back with an empty queue).
            self._dispatch_central(now, events)

    def _apply_link_fault(self, ev) -> None:
        """Degrade (multiply bandwidth / add loss) or restore the
        matching directed links, then drop every derived cost plane.
        Degradations compose; restore returns to the pre-fault table."""
        if self._pristine_links is None:
            self._pristine_links = dict(self._links)
        if ev.pairs is not None:
            wanted = set(ev.pairs)
            match = wanted.__contains__
        else:
            match = lambda pair: ev.site in pair and pair[0] != pair[1]
        changed = False
        for pair, link in list(self._links.items()):
            if not match(pair):
                continue
            if ev.kind == "link_degrade":
                self._links[pair] = NetworkLink(
                    bandwidth_Bps=link.bandwidth_Bps * ev.bandwidth_factor,
                    loss_rate=min(0.999, link.loss_rate + ev.loss_add),
                    rtt_s=link.rtt_s,
                    mss_bytes=link.mss_bytes,
                )
            else:
                self._links[pair] = self._pristine_links.get(pair, link)
            changed = True
        if changed:
            self.invalidate_links()

    def _reset_faults(self) -> None:
        """Restore construction-time liveness and link state so every
        ``run()`` replays its plan from a clean slate."""
        if getattr(self, "_pristine_links", None) is not None:
            self.links = dict(self._pristine_links)  # setter invalidates
        for site in self.sites.values():
            site.alive = True
            site.running.clear()
        self._alive_vec[:] = True
        self._dead = 0
        self._run_token.clear()

    def _on_migrate_check(self, now: float, events: list) -> None:
        """§IX/§X: congested sites push Q4 jobs to cheaper peers.

        The batched engine evaluates each congested site's whole Q4
        candidate set as one (J, S) matrix pass; sites are still visited
        in sequence (an import mutates the target's queue, congestion
        window and Q4 membership, so a later site's candidate set
        genuinely depends on earlier sites' moves — a global upfront
        collection could not stay bit-identical)."""
        batched = (
            self.batch_migration
            and self.policy == "diana"
            and self._link_matrices_ready()
        )
        if not batched:
            for name, site in self.sites.items():
                if (
                    site.use_mlfq
                    and site.alive
                    and site.mlfq.congested(self.congestion_window_s, now)
                ):
                    self._migrate_site_sequential(name, site, now, events)
            return
        self._mig_prio_cache.clear()
        sp: Optional[SitePack] = None
        idx = self._site_idx
        for name, site in self.sites.items():
            if not site.use_mlfq or not site.alive:
                continue
            if not site.mlfq.congested(self.congestion_window_s, now):
                continue
            cands = list(site.mlfq.low_priority_jobs())
            if not cands:
                continue
            sjs = [self._cj2sj[cj.job_id] for cj in cands]
            if sp is None:
                sp = self._site_pack()
            if not all(
                sj.origin_site in idx
                and (sj.data_site is None or sj.data_site in idx)
                for sj in sjs
            ):
                # Off-grid endpoints (e.g. a storage element) can't use
                # the dense planes — fall back per job for this site and
                # resync the packed state it mutated.
                touched = self._migrate_site_sequential(name, site, now, events)
                self._resync_pack(sp, touched)
                continue
            self._migrate_site_batched(name, site, cands, sjs, sp, now, events)

    def _migrate_site_sequential(
        self, name: str, site: _Site, now: float, events: list
    ) -> set[str]:
        """The per-job §IX reference loop for one congested site.
        Returns the sites whose queues it mutated."""
        touched: set[str] = set()
        stale = self._migration_staleness(name, now)
        trusted = None
        if stale is not None:
            stale = stale.tolist()      # one readback for the per-peer walk
            trusted = {
                n for n in self.sites
                if stale[self._site_idx[n]] <= self.migration_max_staleness_s
            }
        for cj in list(site.mlfq.low_priority_jobs()):
            sj = self._cj2sj[cj.job_id]
            peers = [
                PeerView(
                    name=p,
                    queue_length=self.sites[p].queue_len(),
                    jobs_ahead=self.sites[p].mlfq.jobs_ahead(cj.priority),
                    total_cost=self.placement_cost(sj, p),
                )
                for p in self.sites
                if p != name
                and self.sites[p].alive
                and (trusted is None or p in trusted)
            ]
            decision = select_peer(
                cj, name,
                site.mlfq.jobs_ahead(cj.priority),
                self.placement_cost(sj, name),
                peers,
            )
            if decision.migrate and decision.target:
                self._apply_migration_decision(name, site, cj, sj, decision, now, events)
                touched.update((name, decision.target))
        return touched

    def _apply_migration_decision(
        self,
        name: str,
        site: _Site,
        cj: Job,
        sj: SimJob,
        decision,
        now: float,
        events: list,
    ) -> None:
        """Commit one §IX move: export bookkeeping, enqueue at the
        target (which §X-reprioritizes it), dispatch."""
        site.mlfq.remove(cj)
        apply_migration(cj, decision)
        sj.migrated = True
        sj.exec_site = decision.target
        self._dirty_site(name)
        self._bucket(name, "exported", now)
        self._bucket(decision.target, "imported", now)
        self.sites[decision.target].enqueue(cj, now)
        self._dirty_site(decision.target)
        self._dispatch(decision.target, now, events)

    # -- batched §IX machinery ------------------------------------------------
    def _site_pack(self) -> SitePack:
        """Reused dense site-state pack (sorted-name columns). Built
        once; across event horizons only the columns dirtied since the
        last refresh are re-read (``_dirty_site`` marks them), so a
        mostly-idle 1k-site grid refreshes a handful of columns per
        migration tick instead of all S. Re-reading a column yields the
        identical floats a full refresh would, so the narrowing is
        bit-identical."""
        if self._sp is None:
            states = {n: self.sites[n].state() for n in self._names_sorted}
            links = {n: NetworkLink(bandwidth_Bps=1.0) for n in self._names_sorted}
            self._sp = SitePack.from_scheduler(states, links, order=self._names_sorted,
                                               device=self.device)
            self._sp_dirty = set()
        elif self._sp_dirty:
            names = sorted(self._sp_dirty)
            self._sp.refresh_from(
                lambda n: self.sites[n].state(), only=names
            )
            self._sp_dirty.clear()
        return self._sp

    def _resync_pack(self, sp: SitePack, touched: set[str]) -> None:
        """Re-read the packed dynamic columns (and drop cached priority
        arrays) for sites whose queues just changed."""
        if not touched:
            return
        for tn in touched:
            self._mig_prio_cache.pop(tn, None)
        sp.refresh_dynamic(
            {tn: self.sites[tn].state() for tn in touched}, only=list(touched)
        )
        if self._sp_dirty is not None:
            self._sp_dirty -= touched

    def _sorted_priorities(self, name: str) -> np.ndarray:
        """Ascending priority array of one site's queued jobs, cached
        per migration tick (invalidated for sites a move touches)."""
        arr = self._mig_prio_cache.get(name)
        if arr is None:
            arr = np.sort(
                np.asarray(
                    [j.priority for j in self.sites[name].mlfq.jobs], np.float64
                )
            )
            self._mig_prio_cache[name] = arr
        return arr

    def _jobs_ahead_plane(self, names: list[str], cand_p: torch.Tensor) -> torch.Tensor:
        """Vectorized ``mlfq.jobs_ahead`` over peers: the (R, len(names))
        count of queued jobs at each named site with priority ≥ each
        candidate's priority. The sites' sorted priorities go to the
        device as one +inf-padded (n, L) table (one host→device copy),
        then one batched ``searchsorted``: padding sorts after every
        finite priority, so the left insertion point is the unpadded
        one."""
        arrs = [self._sorted_priorities(n) for n in names]
        L = max(1, max(len(a) for a in arrs))
        table = np.full((len(names), L + 1), np.inf)
        for r, a in enumerate(arrs):
            table[r, : len(a)] = a
            table[r, L] = len(a)
        t = torch.from_numpy(table).to(self.device)
        at = torch.searchsorted(
            t[:, :L].contiguous(), cand_p[None, :].expand(len(names), -1).contiguous(),
            side="left",
        )
        return (t[:, L:] - at).T

    def _migration_tables(self, name: str, cands: list[Job], sjs: list[SimJob], now: float):
        """What a congested site's pass needs: the candidates' work and
        priority columns, their static (net, dtc) rows in sorted order,
        the dense jobs-ahead plane in dict order, the pinned and
        excluded masks and the staleness columns."""
        dev = self.device
        names = self._dict_names
        jp = JobPack.from_jobs(cands, device=dev)
        cand_p = torch.as_tensor([cj.priority for cj in cands], dtype=_F64, device=dev)
        net, dtc = self._static_cost_rows(sjs)
        ja = self._jobs_ahead_plane(names, cand_p)
        pinned = torch.as_tensor([cj.migrated for cj in cands], dtype=torch.bool, device=dev)
        excluded = torch.as_tensor(
            [n == name or not self.sites[n].alive for n in names], dtype=torch.bool, device=dev
        )
        # P2P mode: only poll peers whose advertised rows are fresh
        # enough (sorted-order staleness permuted into dict order).
        stale = self._migration_staleness(name, now)
        stale_d = None if stale is None else torch.as_tensor(stale, dtype=_F64, device=dev)[self._dict_perm]
        return jp.work, cand_p, net, dtc, ja, pinned, excluded, stale_d

    def _cost_columns(self, sp: SitePack, work, net, dtc, names: list[str]) -> tuple[list[int], torch.Tensor]:
        """(dict columns, (R, k) costs) of the named sites, recomputed in
        placement_cost's exact op order from the live pack:
        (net + (comp_site + w/cap)) + dtc."""
        comp = comp_site_column(sp, self.weights)
        sc = torch.as_tensor([self._site_idx[n] for n in names], device=self.device)
        cols = (net[:, sc] + (comp[sc][None, :] + work[:, None] / sp.cap[sc][None, :])) + dtc[:, sc]
        return [self._dict_pos[n] for n in names], cols

    def _migrate_site_batched(
        self,
        name: str,
        site: _Site,
        cands: list[Job],
        sjs: list[SimJob],
        sp: SitePack,
        now: float,
        events: list,
    ) -> None:
        """One congested site's §IX pass as a matrix program on the device.

        All candidate × peer placement costs come from the memoized
        static (net, dtc) planes plus one dynamic computation column
        read from the reused SitePack; jobsAhead is one batched
        searchsorted over the peers' sorted priorities. Decisions are
        taken by ``select_peer_targets`` and applied in candidate order;
        an applied move mutates exactly two sites (source and target),
        so only those two columns are recomputed and the remaining rows
        re-decided — every decision is bit-identical to the sequential
        per-job loop. One readback (migrate, target, reason) per
        decision round; a round is a few dozen small launches."""
        if self.config.placement == "hier":
            self._migrate_site_lazy(name, site, cands, sjs, sp, now, events)
            return
        R = len(cands)
        perm = self._dict_perm
        names = self._dict_names
        local_col = self._dict_pos[name]
        work, cand_p, net, dtc, ja, pinned, excluded, stale_d = self._migration_tables(
            name, cands, sjs, now)
        cap_d = sp.cap[perm]
        comp_d = comp_site_column(sp, self.weights)[perm]
        cost = (net[:, perm] + (comp_d[None, :] + work[:, None] / cap_d[None, :])) + dtc[:, perm]
        kw = dict(staleness=stale_d, max_staleness=self.migration_max_staleness_s)

        def decide(lo: int) -> tuple[list, list, list]:
            c = cost[lo:]
            migrate, best = select_peer_targets(
                pinned[lo:], ja[lo:, local_col], c[:, local_col], excluded, ja[lo:], c, **kw)
            lower = c.gather(1, best[:, None])[:, 0] <= c[:, local_col]
            return torch.stack((migrate.to(torch.int64), best, lower.to(torch.int64))).tolist()

        i = 0
        migrate, best, lower = decide(0)
        while i < R:
            off = next((r for r, m in enumerate(migrate) if m), None)
            if off is None:
                break
            i += off
            c = best[off]
            target = names[c]
            d = MigrationDecision(
                True, target=target,
                reason="peer has fewer jobs ahead at lower cost" if lower[off]
                else "peer has fewer jobs ahead",
            )
            self._apply_migration_decision(name, site, cands[i], sjs[i], d, now, events)
            # The move touched exactly {source, target}: re-read those
            # two columns and re-decide the remaining candidates.
            self._resync_pack(sp, {name, target})
            i += 1
            if i >= R:
                break
            dcols, vals = self._cost_columns(sp, work, net, dtc, [name, target])
            cost[:, dcols] = vals
            ja[:, dcols] = self._jobs_ahead_plane([name, target], cand_p)
            migrate, best, lower = decide(i)

    def _migrate_site_lazy(
        self,
        name: str,
        site: _Site,
        cands: list[Job],
        sjs: list[SimJob],
        sp: SitePack,
        now: float,
        events: list,
    ) -> None:
        """``_migrate_site_batched`` with the candidate × peer §IV cost
        plane evaluated lazily (``placement="hier"``).

        The §IX key is (jobsAhead, cost)-lexicographic, so the cost is
        only ever read at min-jobsAhead candidate columns;
        ``select_peer_targets_lazy`` asks for exactly those and this
        pass materializes them from the memoized static planes.
        jobsAhead stays dense. Decisions, reason strings and applied
        moves are bit-identical to the dense pass: a lazily-computed
        column is the same elementwise float program as its dense twin,
        and columns recomputed after a move only differ at the two
        sites the move actually touched."""
        R = len(cands)
        perm = self._dict_perm
        names = self._dict_names
        local_col = self._dict_pos[name]
        S = len(names)
        dev = self.device
        work, cand_p, net, dtc, ja, pinned, excluded, stale_d = self._migration_tables(
            name, cands, sjs, now)
        net_d, dtc_d = net[:, perm], dtc[:, perm]
        cap_d = sp.cap[perm]
        costm = torch.empty((R, S), dtype=_F64, device=dev)
        have = torch.zeros(S, dtype=torch.bool, device=dev)
        comp_d = [comp_site_column(sp, self.weights)[perm]]

        def _fill(cols: torch.Tensor) -> None:
            need = cols[~have[cols]]
            if need.numel():
                # placement_cost's exact op order, sliced per column:
                # (net + (comp_site + w/cap)) + dtc
                costm[:, need] = (
                    net_d[:, need]
                    + (comp_d[0][need][None, :] + work[:, None] / cap_d[need][None, :])
                ) + dtc_d[:, need]
                have[need] = True

        def _cost_rows(lo: int):
            def cb(cols: torch.Tensor) -> torch.Tensor:
                _fill(cols)
                return costm[lo:, cols]
            return cb

        _fill(torch.as_tensor([local_col], dtype=torch.int64, device=dev))
        kw = dict(staleness=stale_d, max_staleness=self.migration_max_staleness_s)

        def decide(lo: int) -> tuple[list, list, list]:
            migrate, best, bcost = select_peer_targets_lazy(
                pinned[lo:], ja[lo:, local_col], costm[lo:, local_col], excluded, ja[lo:],
                _cost_rows(lo), **kw)
            lower = bcost <= costm[lo:, local_col]
            return torch.stack((migrate.to(torch.int64), best, lower.to(torch.int64))).tolist()

        i = 0
        migrate, best, lower = decide(0)
        while i < R:
            off = next((r for r, m in enumerate(migrate) if m), None)
            if off is None:
                break
            i += off
            target = names[best[off]]
            d = MigrationDecision(
                True, target=target,
                reason="peer has fewer jobs ahead at lower cost" if lower[off]
                else "peer has fewer jobs ahead",
            )
            self._apply_migration_decision(name, site, cands[i], sjs[i], d, now, events)
            # The move touched exactly {source, target}: re-read those
            # two columns and re-decide the remaining candidates (the
            # untouched cached columns recompute to identical floats).
            self._resync_pack(sp, {name, target})
            i += 1
            if i >= R:
                break
            comp_d[0] = comp_site_column(sp, self.weights)[perm]
            dcols, vals = self._cost_columns(sp, work, net, dtc, [name, target])
            costm[:, dcols] = vals
            have[dcols] = True
            ja[:, dcols] = self._jobs_ahead_plane([name, target], cand_p)
            migrate, best, lower = decide(i)
