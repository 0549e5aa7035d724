"""Timestamped fault injection for the grid simulator.

The paper's migration and P2P machinery (§IX/§X) exists because real
grids misbehave: sites die and come back, schedulers (peers) leave and
rejoin, WAN links degrade. A ``FaultPlan`` is a deterministic, replayable
script of such events; ``GridSim.run`` interleaves it into the event
stream (both the batched event-horizon loop and the per-event reference
loop, bit-identically) via ``SimConfig.fault_plan``.

Event kinds:

* ``site_down`` / ``site_up`` — flip one site's alive bit. Going down
  kills the site's running jobs (their pending completion events are
  invalidated) and drains its queue; every displaced job re-enters
  placement through the §IX migration path (cost-ranked over the
  alive sites) and is counted in ``StreamStats.requeued`` and the
  ``"requeued"`` timeline bucket. Placement never selects a dead site,
  and a stale-view (P2P) submission aimed at one bounces off the
  authoritative grid and is redirected (``StreamStats.redirected``).
* ``peer_leave`` / ``peer_join`` — P2P scheduler churn
  (``P2PGridSim`` only). On leave the departing peer hands its home
  partition over to the next active peer
  (``PeerScheduler.handover()``/``adopt()`` — the epoch sequence
  continues, so receivers' strictly-newer merges keep converging) and
  drops out of the gossip fan-out. On join the partition is handed
  back and the delta wire's table-bearing full-sync path
  resynchronizes the rejoiner's world view.
* ``link_degrade`` / ``link_restore`` — multiply bandwidth /
  add loss on the matching directed WAN links (either every non-local
  link touching ``site``, or the explicit directed ``pairs``), then
  invalidate every derived cost plane. Degrade factors compose;
  restore returns the matching links to their pre-fault table.
  In-flight transfers are not re-priced: a running job's committed
  finish time stands (the degradation applies from the next placement
  on).

A fault-plan sim may be ``run()`` repeatedly: liveness, link state and
(in ``P2PGridSim``) peer home partitions are restored to the
construction-time layout at the start of every run, so each run
replays the plan against a healthy grid. (Peer *world views* carry
over between runs, exactly as they always have without faults.)

Plain Python, carried over from the reference's ``sim/faults.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

__all__ = [
    "FaultEvent",
    "FaultPlan",
    "FAULT_KINDS",
    "PartitionWindow",
    "TransportFaults",
]

FAULT_KINDS = (
    "site_down",
    "site_up",
    "peer_leave",
    "peer_join",
    "link_degrade",
    "link_restore",
)

_SITE_KINDS = ("site_down", "site_up")
_PEER_KINDS = ("peer_leave", "peer_join")
_LINK_KINDS = ("link_degrade", "link_restore")


@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault. ``site`` names the target of site/link
    events (link events may instead carry explicit directed ``pairs``);
    ``peer`` is the P2P peer index for churn events."""

    time: float
    kind: str
    site: Optional[str] = None
    peer: Optional[int] = None
    pairs: Optional[tuple[tuple[str, str], ...]] = None
    bandwidth_factor: float = 1.0
    loss_add: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if not math.isfinite(self.time):
            raise ValueError(f"fault time must be finite, got {self.time}")
        if self.time < 0.0:
            raise ValueError(f"fault time must be >= 0, got {self.time}")
        if self.kind in _SITE_KINDS and self.site is None:
            raise ValueError(f"{self.kind} requires site=")
        if self.kind in _PEER_KINDS and self.peer is None:
            raise ValueError(f"{self.kind} requires peer=")
        if self.kind in _LINK_KINDS and self.site is None and self.pairs is None:
            raise ValueError(f"{self.kind} requires site= or pairs=")
        if self.kind == "link_degrade":
            if self.bandwidth_factor <= 0.0:
                raise ValueError("bandwidth_factor must be > 0")
            if self.loss_add < 0.0:
                raise ValueError("loss_add must be >= 0")


@dataclass
class FaultPlan:
    """An ordered script of ``FaultEvent``s. Builder methods append and
    return ``self`` so plans chain:

        FaultPlan().site_down(300.0, "site3").site_up(900.0, "site3")

    Events are replayed in (time, insertion-order) — ties between two
    scripted events break by the order they were added, identically in
    both run loops.
    """

    events: list[FaultEvent] = field(default_factory=list)

    # -- builders -----------------------------------------------------------
    def add(self, event: FaultEvent) -> "FaultPlan":
        self.events.append(event)
        return self

    def site_down(self, time: float, site: str) -> "FaultPlan":
        return self.add(FaultEvent(time=time, kind="site_down", site=site))

    def site_up(self, time: float, site: str) -> "FaultPlan":
        return self.add(FaultEvent(time=time, kind="site_up", site=site))

    def peer_leave(self, time: float, peer: int) -> "FaultPlan":
        return self.add(FaultEvent(time=time, kind="peer_leave", peer=peer))

    def peer_join(self, time: float, peer: int) -> "FaultPlan":
        return self.add(FaultEvent(time=time, kind="peer_join", peer=peer))

    def link_degrade(
        self,
        time: float,
        site: Optional[str] = None,
        pairs: Optional[Sequence[tuple[str, str]]] = None,
        bandwidth_factor: float = 1.0,
        loss_add: float = 0.0,
    ) -> "FaultPlan":
        return self.add(
            FaultEvent(
                time=time, kind="link_degrade", site=site,
                pairs=tuple(pairs) if pairs is not None else None,
                bandwidth_factor=bandwidth_factor, loss_add=loss_add,
            )
        )

    def link_restore(
        self,
        time: float,
        site: Optional[str] = None,
        pairs: Optional[Sequence[tuple[str, str]]] = None,
    ) -> "FaultPlan":
        return self.add(
            FaultEvent(
                time=time, kind="link_restore", site=site,
                pairs=tuple(pairs) if pairs is not None else None,
            )
        )

    # -- introspection -------------------------------------------------------
    def sorted_events(self) -> list[FaultEvent]:
        """Events in replay order: stable sort by time (insertion order
        breaks ties)."""
        return sorted(self.events, key=lambda e: e.time)

    @property
    def has_peer_events(self) -> bool:
        return any(e.kind in _PEER_KINDS for e in self.events)

    def down_intervals(self) -> dict[str, list[tuple[float, float]]]:
        """Per site, the [down, up) windows the plan scripts (an
        unrecovered site's last window ends at +inf). Verifiers use
        this to assert that no job ever completed on a dead site."""
        out: dict[str, list[tuple[float, float]]] = {}
        open_at: dict[str, float] = {}
        for ev in self.sorted_events():
            if ev.kind == "site_down" and ev.site not in open_at:
                open_at[ev.site] = ev.time
            elif ev.kind == "site_up" and ev.site in open_at:
                out.setdefault(ev.site, []).append((open_at.pop(ev.site), ev.time))
        for site, t0 in open_at.items():
            out.setdefault(site, []).append((t0, float("inf")))
        return out

    def dead_at(self, site: str, t: float) -> bool:
        """Whether the plan scripts ``site`` as down at time ``t``
        (down-inclusive, up-exclusive)."""
        return any(
            t0 <= t < t1 for t0, t1 in self.down_intervals().get(site, ())
        )

    def check(self) -> "FaultPlan":
        """Build-time coherence validation, grid-independent: replay
        the plan in chronological order and reject sequences that
        cannot describe a real fault history —

        * ``site_down`` for a site already down;
        * ``site_up`` for a site that is not down (this is also how an
          out-of-order timestamp pair — the up scripted to fire before
          its own down — surfaces);
        * ``peer_leave`` for a peer already departed, ``peer_join``
          for a peer that never left (same out-of-order coverage);
        * ``link_restore`` with no chronologically earlier
          ``link_degrade`` on the same target (``site=``/``pairs=``).

        Insertion order is irrelevant — builders may append events out
        of chronology; only the replayed (time-sorted) order must
        cohere. Called automatically by ``validate`` (which the sims
        run at ``run()`` time); call it directly to fail fast while
        building a plan. Returns ``self`` so it chains."""
        down: set[str] = set()
        departed: set[int] = set()
        degraded: set[tuple] = set()
        for ev in self.sorted_events():
            if ev.kind == "site_down":
                if ev.site in down:
                    raise ValueError(
                        f"incoherent fault plan: site {ev.site!r} taken down "
                        f"at t={ev.time:g} while already down"
                    )
                down.add(ev.site)
            elif ev.kind == "site_up":
                if ev.site not in down:
                    raise ValueError(
                        f"incoherent fault plan: site_up for {ev.site!r} at "
                        f"t={ev.time:g} but the site is not down at that time "
                        "(never taken down, or the timestamps are out of order)"
                    )
                down.discard(ev.site)
            elif ev.kind == "peer_leave":
                if ev.peer in departed:
                    raise ValueError(
                        f"incoherent fault plan: peer {ev.peer} leaves at "
                        f"t={ev.time:g} while already departed"
                    )
                departed.add(ev.peer)
            elif ev.kind == "peer_join":
                if ev.peer not in departed:
                    raise ValueError(
                        f"incoherent fault plan: peer {ev.peer} joins at "
                        f"t={ev.time:g} without having left by that time "
                        "(never departed, or the timestamps are out of order)"
                    )
                departed.discard(ev.peer)
            elif ev.kind == "link_degrade":
                degraded.add((ev.site, ev.pairs))
            elif ev.kind == "link_restore":
                if (ev.site, ev.pairs) not in degraded:
                    raise ValueError(
                        f"incoherent fault plan: link_restore at "
                        f"t={ev.time:g} (site={ev.site!r}, pairs={ev.pairs!r}) "
                        "has no earlier link_degrade on the same target"
                    )
        return self

    def validate(
        self,
        sites: Optional[set[str]] = None,
        num_peers: Optional[int] = None,
    ) -> None:
        """Static plan checks against a concrete grid, on top of the
        grid-independent coherence pass (``check``). ``sites`` is the
        grid's site-name set (link-event endpoints may legitimately
        name off-grid link-table nodes, so only site_down/site_up
        targets are checked); ``num_peers=None`` means the running sim
        has no peers at all — any churn event is then an error."""
        self.check()
        if sites is not None:
            for ev in self.events:
                if ev.kind in _SITE_KINDS and ev.site not in sites:
                    raise ValueError(
                        f"fault plan names unknown site {ev.site!r} "
                        f"(grid sites: {sorted(sites)})"
                    )
        if self.has_peer_events and num_peers is None:
            raise ValueError(
                "fault plan contains peer_leave/peer_join events, which "
                "require the multi-scheduler P2PGridSim (peer churn has "
                "no meaning with a single omniscient scheduler)"
            )
        if num_peers is not None:
            departed: set[int] = set()
            for ev in self.sorted_events():
                if ev.kind not in _PEER_KINDS:
                    continue
                if not 0 <= ev.peer < num_peers:
                    raise ValueError(
                        f"fault plan names peer {ev.peer} but the sim has "
                        f"{num_peers} peer(s)"
                    )
                if ev.kind == "peer_leave":
                    departed.add(ev.peer)  # alternation enforced by check()
                    if len(departed) >= num_peers:
                        raise ValueError("fault plan departs every peer at once")
                else:
                    departed.discard(ev.peer)


@dataclass(frozen=True)
class PartitionWindow:
    """A scripted full network partition: during [start, end) no
    gossip message crosses between the named groups (canonically the
    RootGrid tiers' site-name sets). Traffic inside a group, and
    traffic involving a site listed in no group, flows normally —
    partitions model severed inter-tier WAN trunks, not dead peers."""

    start: float
    end: float
    groups: tuple[frozenset[str], ...]

    def __post_init__(self):
        if not (math.isfinite(self.start) and self.start >= 0.0):
            raise ValueError(f"partition start must be finite and >= 0, got {self.start}")
        if not self.end > self.start:  # also rejects NaN
            raise ValueError(
                f"partition must end after it starts, got [{self.start}, {self.end})"
            )
        groups = tuple(frozenset(g) for g in self.groups)
        if len(groups) < 2:
            raise ValueError("a partition needs at least two groups")
        seen: set[str] = set()
        for g in groups:
            if not g:
                raise ValueError("partition groups must be non-empty")
            if seen & g:
                raise ValueError(
                    f"partition groups overlap on {sorted(seen & g)}"
                )
            seen |= g
        object.__setattr__(self, "groups", groups)

    def blocks(self, a: str, b: str, t: float) -> bool:
        """Whether a message between homes ``a`` and ``b`` is severed
        at time ``t`` (start-inclusive, end-exclusive)."""
        if not self.start <= t < self.end:
            return False
        ga = gb = None
        for k, g in enumerate(self.groups):
            if a in g:
                ga = k
            if b in g:
                gb = k
        return ga is not None and gb is not None and ga != gb


def _prob(name: str, v: float) -> None:
    if not 0.0 <= v <= 1.0:
        raise ValueError(f"{name} must be a probability in [0, 1], got {v}")


@dataclass(frozen=True)
class TransportFaults:
    """Stochastic unreliable-transport model for ``GossipExchange``.

    Every gossip message (delta packets, full-wire advert datagrams,
    acks) draws its fate from one seeded RNG inside the exchange, so
    runs replay bit-identically in both simulator loops:

    * ``loss`` — iid drop probability per message.
    * ``burst_p``/``burst_r``/``burst_loss`` — Gilbert–Elliott burst
      layer per directed peer pair: enter the bad state with prob
      ``burst_p`` per message, recover with ``burst_r``, drop with
      ``burst_loss`` while bad. Composes with (applies before) ``loss``.
    * ``duplicate`` — probability a surviving message is delivered
      twice (the copy takes its own reorder jitter).
    * ``reorder_jitter_s`` — extra uniform [0, jitter) delivery delay
      per copy, on top of the exchange's fixed latency; with several
      messages in flight this reorders arrivals.
    * ``corrupt`` — probability of a single flipped bit per delta
      packet copy (caught by the packet checksum and dropped at the
      receiver); full-wire datagrams are dropped whole instead.
    * ``partitions`` — scripted ``PartitionWindow``s: deterministic
      full severance between site groups (RootGrid tiers).

    Recovery knobs: un-acked delta packets retransmit after ``rto_s``
    (default: four one-way latencies, min 1 s), backing off by
    ``rto_backoff`` with up to ``rto_jitter`` relative jitter, at most
    ``max_retransmits`` times before the pair escalates to a forced
    full sync. ``phi_threshold``/``phi_window`` tune the phi-accrual
    failure detector that grades per-sender suspicion from delivery
    gaps (larger threshold = slower to suspect).

    All-zero rates with no partitions (``enabled`` False) still engage
    the protocol machinery — sequence numbers, checksums, acks — but
    deliver every message exactly once with no extra delay, so results
    are identical to running without a transport model at all.
    """

    seed: int = 0
    loss: float = 0.0
    duplicate: float = 0.0
    corrupt: float = 0.0
    reorder_jitter_s: float = 0.0
    burst_p: float = 0.0
    burst_r: float = 0.5
    burst_loss: float = 1.0
    partitions: tuple[PartitionWindow, ...] = ()
    rto_s: Optional[float] = None
    rto_backoff: float = 2.0
    rto_jitter: float = 0.1
    max_retransmits: int = 4
    phi_threshold: float = 8.0
    phi_window: int = 16

    def __post_init__(self):
        for name in ("loss", "duplicate", "corrupt", "burst_p", "burst_r", "burst_loss"):
            _prob(name, getattr(self, name))
        if self.reorder_jitter_s < 0.0:
            raise ValueError(f"reorder_jitter_s must be >= 0, got {self.reorder_jitter_s}")
        if self.rto_s is not None and self.rto_s <= 0.0:
            raise ValueError(f"rto_s must be > 0 (or None for auto), got {self.rto_s}")
        if self.rto_backoff < 1.0:
            raise ValueError(f"rto_backoff must be >= 1, got {self.rto_backoff}")
        if self.rto_jitter < 0.0:
            raise ValueError(f"rto_jitter must be >= 0, got {self.rto_jitter}")
        if self.max_retransmits < 0:
            raise ValueError(f"max_retransmits must be >= 0, got {self.max_retransmits}")
        if self.phi_threshold <= 0.0:
            raise ValueError(f"phi_threshold must be > 0, got {self.phi_threshold}")
        if self.phi_window < 2:
            raise ValueError(f"phi_window must be >= 2, got {self.phi_window}")
        if self.burst_p > 0.0 and self.burst_r <= 0.0:
            raise ValueError("burst_r must be > 0 when burst_p > 0 (bursts must end)")
        object.__setattr__(self, "partitions", tuple(self.partitions))

    @property
    def enabled(self) -> bool:
        """Whether any fault can actually occur."""
        return bool(
            self.loss > 0.0
            or self.duplicate > 0.0
            or self.corrupt > 0.0
            or self.reorder_jitter_s > 0.0
            or self.burst_p > 0.0
            or self.partitions
        )

    @property
    def can_lose(self) -> bool:
        """Whether a message can fail to arrive at all (loss, burst,
        corruption, or partition — duplication and jitter only delay).
        The exchange skips arming retransmit timers when False."""
        return bool(
            self.loss > 0.0
            or self.corrupt > 0.0
            or self.burst_p > 0.0
            or self.partitions
        )

    def partitioned(self, a: str, b: str, t: float) -> bool:
        """Whether homes ``a`` and ``b`` are severed at time ``t`` by
        any scripted partition window."""
        return any(w.blocks(a, b, t) for w in self.partitions)
