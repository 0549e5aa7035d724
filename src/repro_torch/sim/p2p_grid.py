"""Multi-scheduler mode of the §XI simulator: the paper's decentralized
deployment (§III/§IX) over ``GridSim``'s event stream, on a device.

The grid's sites are partitioned round-robin (sorted order) across
``num_peers`` ``PeerScheduler``s whose world views, version and stamp
vectors live on the simulator's device (the CUDA card unless
``device="cpu"``). Each peer owns its partition's authoritative state
and sees every other site only through the ``GossipExchange``; a job is
placed by the peer owning its origin site, from that peer's possibly
stale view. §IX migration polls only peers whose advertised rows are
fresh enough. ``num_peers=1`` is the omniscient special case: the event
stream equals ``GridSim``'s bit for bit.

This class subclasses the port's ``GridSim`` through its hooks
(``_dirty_site``, ``_on_stream_start``, ``_on_exchange``, ``_on_deliver``,
``_migration_staleness`` and the peer-fault branch of ``_on_fault``);
the computation column, the suspicion masks and the staleness columns
are device tensors, and every argmin is NumPy's (``first_min_index``).
"""
from __future__ import annotations

import heapq
import math
from typing import Optional

import torch

from ..core import NetworkLink, PeerScheduler, stable_user_peer
from ..core.batch import comp_site_column
from ..core.migration import first_min_index
from ..core.p2p import GossipExchange
from .config import _ALL_FIELDS, SimConfig, resolve_config
from .grid import GridSim
from .workloads import SimJob

__all__ = ["P2PGridSim"]


class P2PGridSim(GridSim):
    """``GridSim`` with N peer schedulers exchanging cost rows by gossip
    every ``exchange_interval_s`` (delivered ``exchange_latency_s``
    later). Placements the submitting peer makes onto remote sites bump
    its own view optimistically; the owning site reconciles by queueing
    whatever arrives. A congested site migrates only to peers whose rows
    are at most ``migration_max_staleness_s`` old (default: the hops a
    row needs to arrive, plus one, exchange intervals and the latency).
    ``device`` is a keyword, as on ``GridSim``."""

    #: P2PGridSim accepts the full SimConfig surface as legacy kwargs.
    _LEGACY_FIELDS = _ALL_FIELDS

    def __init__(
        self,
        site_nodes: dict[str, int],
        links: Optional[dict[tuple[str, str], NetworkLink]] = None,
        config: Optional[SimConfig] = None,
        *,
        device=None,
        **kw,
    ):
        cfg = resolve_config(config, kw, self._LEGACY_FIELDS, type(self).__name__)
        if cfg.policy != "diana":
            raise ValueError("multi-scheduler mode requires the 'diana' policy")
        if cfg.exchange_interval_s <= 0.0:
            raise ValueError(
                "exchange_interval_s must be > 0 (the run loop schedules "
                "exchange rounds at this period)"
            )
        super().__init__(site_nodes, links=links, config=cfg, device=device)
        self.exchange_interval_s = float(cfg.exchange_interval_s)
        self.exchange_latency_s = float(cfg.exchange_latency_s)
        migration_max_staleness_s = cfg.migration_max_staleness_s
        topology = cfg.topology
        gossip_fanout = cfg.gossip_fanout
        names = self._names_sorted
        N = max(1, min(int(cfg.num_peers), len(names)))
        self.num_peers = N
        if migration_max_staleness_s is None:
            # Rounds a row may be behind on arrival: one relay hop on a
            # mesh, ~3 through tier representatives, and a capped fan-out
            # hears an owner only every ceil(neighbors / fanout) rounds.
            hops = 3 if topology is not None else 1
            if gossip_fanout is not None and N > 1:
                rotation = -(-(N - 1) // max(1, int(gossip_fanout)))
                hops = max(hops, rotation)
            migration_max_staleness_s = (
                (1 + hops) * self.exchange_interval_s + self.exchange_latency_s
            )
        self.migration_max_staleness_s = float(migration_max_staleness_s)
        states = {n: self.sites[n].state() for n in names}
        # The event loop reads only the peers' dynamic columns; each
        # peer's link row backs the public PeerScheduler API (its
        # home-relative row of the real table, or a placeholder when
        # the table is partial).
        self.peers = []
        for i in range(N):
            home = names[i]
            try:
                plinks = {n: self.links[(home, n)] for n in names}
            except KeyError:
                plinks = {n: NetworkLink(bandwidth_Bps=1.0) for n in names}
            self.peers.append(
                PeerScheduler(
                    home=home, sites=states, links=plinks, weights=self.weights,
                    home_sites=names[i::N], order=names, device=self.device,
                )
            )
        self._peer_by_site = {}
        for p in self.peers:
            p.state_provider = lambda n: self.sites[n].state()
            # Per-job home refreshes re-read only the mutated home columns.
            p.enable_home_dirty_tracking()
            for n in p.home_names:
                self._peer_by_site[n] = p
        self.exchange = GossipExchange(
            self.peers, topology=topology,
            latency_s=self.exchange_latency_s, fanout=gossip_fanout,
            wire=cfg.gossip_wire, quant=cfg.gossip_quant,
            full_sync_every=cfg.gossip_full_sync_every,
            transport=cfg.transport_faults,
            summaries=cfg.gossip_summaries,
            device=self.device,
        )
        # peer index → the home partition it held when it left.
        self._departed: dict[int, list[str]] = {}
        # Suspicion cache, refreshed at gossip events: peer index → the
        # suspect-column mask (device), and the staleness widening.
        self._peer_index = {id(p): i for i, p in enumerate(self.peers)}
        self._suspect_masks: dict[int, torch.Tensor] = {}
        self._staleness_widen = 1.0

    def _on_stream_start(self, t0: float) -> None:
        # The construction-time view is the join protocol's initial
        # exchange, made at the first arrival.
        if t0 != float("inf"):
            for p in self.peers:
                p.stamp.clamp_(min=t0)

    def _dirty_site(self, name: str) -> None:
        super()._dirty_site(name)
        p = getattr(self, "_peer_by_site", None)
        if p is not None:
            peer = p.get(name)
            if peer is not None:
                peer.mark_home_dirty(name)

    # -- routing ---------------------------------------------------------------
    def _submit_peer(self, sj: SimJob) -> PeerScheduler:
        """The peer owning the job's origin site; off-grid origins hash
        stably by user over the active peers."""
        p = self._peer_by_site.get(sj.origin_site)
        if p is None:
            pool = self.peers
            if self._departed:
                pool = [
                    pp for i, pp in enumerate(self.peers)
                    if i not in self._departed
                ]
            p = stable_user_peer(sj.user, pool)
        return p

    # -- stale-view placement --------------------------------------------------
    def _comp_vec(self, sj: SimJob) -> torch.Tensor:
        """The computation column from the submitting peer's world view:
        home columns re-measured per job, remote columns as last
        advertised; sites the peer believes dead are +inf (the mask is
        applied unconditionally: it leaves an all-alive row unchanged).
        Columns of suspect owners are avoided while a finite column
        remains. No readback."""
        peer = self._submit_peer(sj)
        peer.refresh_home()
        v = peer.view
        out = comp_site_column(v, self.weights) + torch.full_like(v.cap, sj.work) / v.cap
        out = torch.where(v.alive, out, math.inf)
        mask = self._suspect_mask_for(peer)
        if mask is not None:
            masked = torch.where(mask, math.inf, out)
            out = torch.where(torch.isfinite(masked).any(), masked, out)
        return out

    def choose_site(self, sj: SimJob) -> str:
        comp = self._comp_vec(sj).tolist()
        costs = []
        for i, name in enumerate(self._names_sorted):
            net, dtc = self._static_terms(sj, name)
            costs.append((net + comp[i] + dtc, name))
        return min(costs)[1]

    def choose_sites_batch(self, batch: list[SimJob]) -> list[str]:
        """Snapshot API: the memoized static (net, dtc) planes are shared
        across the batch and each row's computation column comes from its
        own peer's view — equal to ``[self.choose_site(sj) for sj in
        batch]``."""
        if not self._batch_eligible(batch):
            return [self.choose_site(sj) for sj in batch]
        net, dtc = self._static_cost_rows(batch)
        if self._hier_ready():
            return [
                self._names_sorted[
                    self._hier_pick(sj, self._comp_vec(sj), net[i], dtc[i])
                ]
                for i, sj in enumerate(batch)
            ]
        return [
            self._names_sorted[int(first_min_index((net[i] + self._comp_vec(sj)) + dtc[i]))]
            for i, sj in enumerate(batch)
        ]

    def _admit(self, sj: SimJob, target: str, now: float, events: list) -> str:
        # The base may redirect a stale-view submission off a dead site;
        # the optimistic feedback follows the job to where it landed.
        target = super()._admit(sj, target, now, events)
        self._submit_peer(sj).note_remote_placement(target, sj.work)
        return target

    # -- peer churn (fault plan peer_leave/peer_join) --------------------------
    def _on_fault(self, ev, now: float, events: list) -> None:
        if ev.kind == "peer_leave":
            self._peer_leave(int(ev.peer), now)
        elif ev.kind == "peer_join":
            self._peer_join(int(ev.peer), now)
        else:
            super()._on_fault(ev, now, events)

    def _peer_leave(self, k: int, now: float) -> None:
        """Graceful departure: the leaver hands its whole partition to the
        next active peer on the ring and drops out of the fan-out."""
        leaver = self.peers[k]
        names = list(leaver.home_names)
        active = [
            i for i in range(self.num_peers)
            if i != k and i not in self._departed
        ]
        succ = min(active, key=lambda i: (i - k) % self.num_peers)
        grant = leaver.handover()
        self.peers[succ].adopt(grant)
        for n in names:
            self._peer_by_site[n] = self.peers[succ]
        self._departed[k] = names
        self.exchange.set_active(k, False)

    def _peer_join(self, k: int, now: float) -> None:
        """Rejoin: the peer takes back exactly the partition it left with
        and re-enters the fan-out (the delta wire's forced full sync
        rebuilds its view)."""
        names = self._departed.pop(k)
        joiner = self.peers[k]
        by_owner: dict[int, list[str]] = {}
        for n in names:
            owner = self._peer_by_site[n]
            oi = next(i for i, p in enumerate(self.peers) if p is owner)
            by_owner.setdefault(oi, []).append(n)
        for oi, ns in by_owner.items():
            joiner.adopt(self.peers[oi].handover(names=ns))
        for n in names:
            self._peer_by_site[n] = joiner
        self.exchange.set_active(k, True)

    def _reset_faults(self) -> None:
        # Departed peers take their partitions back before the base
        # reset; the transport re-arms so each run replays its draws.
        for k in sorted(self._departed):
            self._peer_join(k, 0.0)
        self.exchange.reset_transport()
        self._suspect_masks = {}
        self._staleness_widen = 1.0
        super()._reset_faults()

    # -- exchange events -------------------------------------------------------
    def _on_exchange(self, now: float, events: list) -> None:
        self.exchange.deliver_due(now)
        self.exchange.round(now)
        self._refresh_suspicion(now)
        if self.exchange.in_flight:
            heapq.heappush(
                events, (self.exchange.next_due(), next(self._seq), "deliver", None)
            )

    def _on_deliver(self, now: float, events: list) -> None:
        self.exchange.deliver_due(now)
        self._refresh_suspicion(now)
        # Chain to the next in-flight batch, so every sent advert lands.
        if self.exchange.in_flight:
            heapq.heappush(
                events, (self.exchange.next_due(), next(self._seq), "deliver", None)
            )

    # -- suspicion (unreliable transport) --------------------------------------
    def _refresh_suspicion(self, now: float) -> None:
        """Re-derive the cached suspicion state from the exchange's
        failure detectors: suspect owners' columns are masked out of
        placement and infinitely stale to §IX, and while anyone is
        suspect the trust horizon widens by how far real delivery gaps
        exceed the exchange interval (at most 8×)."""
        ex = self.exchange
        if ex.transport is None:
            return
        if not self._suspect_masks and now < ex.suspicion_quiet_until():
            return
        masks: dict[int, torch.Tensor] = {}
        for i in range(len(self.peers)):
            m = ex.suspect_mask(i, now)
            if m is not None:
                masks[i] = m
        self._suspect_masks = masks
        widen = 1.0
        if masks:
            gap = ex.mean_delivery_gap()
            if gap is not None and gap > self.exchange_interval_s:
                widen = min(8.0, gap / self.exchange_interval_s)
        self._staleness_widen = widen

    def _suspect_mask_for(self, peer: PeerScheduler) -> Optional[torch.Tensor]:
        if not self._suspect_masks:
            return None
        return self._suspect_masks.get(self._peer_index[id(peer)])

    # -- migration trust -------------------------------------------------------
    @property
    def migration_max_staleness_s(self) -> float:
        """The configured trust horizon, widened while suspicion lasts."""
        base = self._migration_max_staleness_base
        return base * self._staleness_widen if self._staleness_widen > 1.0 else base

    @migration_max_staleness_s.setter
    def migration_max_staleness_s(self, value: float) -> None:
        self._migration_max_staleness_base = float(value)

    def _migration_staleness(self, name: str, now: float) -> Optional[torch.Tensor]:
        peer = self._peer_by_site.get(name)
        if peer is None:
            return None
        peer.refresh_home()
        st = peer.staleness(now)
        mask = self._suspect_mask_for(peer)
        if mask is not None:
            # A suspect owner's columns are infinitely stale.
            st = torch.where(mask, math.inf, st)
        return st
