"""Unified simulator configuration (``SimConfig``).

``GridSim``/``P2PGridSim`` grew ~15 keyword arguments across PRs
(migration thresholds, exchange interval/latency, gossip wire options,
batching flags …). ``SimConfig`` is the one structured surface for all
of them:

    sim = GridSim(site_nodes, links, config=SimConfig(policy="diana",
                                                      horizon=True))

The old keyword style keeps working — ``GridSim(site_nodes,
policy="diana", migration_interval_s=30.0)`` — through a compatibility
shim that folds the kwargs into a ``SimConfig`` and emits a single
``DeprecationWarning`` per process (not per construction, so bulk test
suites stay quiet).

Base fields apply to both simulators; the peer-to-peer fields are read
only by ``P2PGridSim`` (passing them to plain ``GridSim`` keyword-style
raises ``TypeError``, exactly like the old signatures did). The port
keeps the reference's fields and shim unchanged, P2P fields included,
so one configuration describes a run of either package; where a
simulator runs (``device``) is a keyword of ``GridSim``, not a field.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Optional

from ..core import CostWeights
from ..core.topology import GridTopology

from .faults import FaultPlan, TransportFaults

__all__ = ["SimConfig"]


@dataclass
class SimConfig:
    """Every knob of ``GridSim``/``P2PGridSim`` in one place."""

    # -- shared (GridSim + P2PGridSim) ------------------------------------
    policy: str = "diana"
    quotas: Optional[dict[str, float]] = None
    migration_interval_s: float = 60.0
    congestion_window_s: float = 300.0
    weights: CostWeights = field(
        default_factory=lambda: CostWeights(w_queue=0.0, w_work=1.0, w_load=0.0)
    )
    bucket_s: float = 60.0
    batch_arrivals: bool = True
    batch_migration: bool = True
    #: Run the batched event-horizon loop (drains same-instant arrival /
    #: completion runs per heap visit; required for streaming
    #: ``ArrivalSource`` inputs to stay lazy). ``False`` selects the
    #: one-pop-per-event reference loop — both are bit-identical on the
    #: same workload.
    horizon: bool = True
    #: Optional arrival-coalescing window: arrivals within
    #: ``horizon_eps_s`` of the first one in a burst are admitted
    #: together at the window-open instant. 0.0 (the default) keeps the
    #: loop exactly event-accurate; > 0 is an explicit approximation
    #: (jobs are admitted up to eps early) and is NOT bit-identical to
    #: the per-event loop.
    horizon_eps_s: float = 0.0
    #: Streaming runs drop finished per-job records by default (the
    #: ``SimResult.stats`` accumulators survive); set ``True`` to
    #: collect every admitted ``SimJob`` anyway. ``run(list)`` always
    #: returns the caller's list regardless of this flag.
    retain_jobs: bool = False
    #: Optional scripted fault injection (``sim.faults.FaultPlan``):
    #: timestamped site-down/site-up, peer leave/join (P2PGridSim
    #: only) and link-degradation events, interleaved into the event
    #: stream identically by both run loops. None = the classic
    #: always-alive grid.
    fault_plan: Optional["FaultPlan"] = None
    #: Placement evaluation path for the diana policy: ``"flat"`` scans
    #: every site per decision; ``"hier"`` runs the two-level tier-bound
    #: argmin (tiers = ``topology`` RootGrids, or one tier without a
    #: topology) — decisions are bit-identical, the dense pass just
    #: shrinks to the winning tier(s).
    placement: str = "flat"
    #: RootGrid/SubGrid control-plane topology. ``P2PGridSim`` uses it
    #: for hierarchical gossip fan-out; both simulators use it as the
    #: tier structure when ``placement="hier"``.
    topology: Optional[GridTopology] = None

    # -- P2PGridSim only --------------------------------------------------
    num_peers: int = 3
    exchange_interval_s: float = 60.0
    exchange_latency_s: float = 0.0
    migration_max_staleness_s: Optional[float] = None
    gossip_fanout: Optional[int] = None
    gossip_wire: str = "delta"
    gossip_quant: str = "f32"
    gossip_full_sync_every: int = 32
    #: Optional unreliable-transport model for the gossip exchange
    #: (``sim.faults.TransportFaults``): seeded stochastic loss /
    #: duplication / reorder / corruption plus scripted partition
    #: windows. None (or an all-zero model) = the classic perfectly
    #: reliable transport.
    transport_faults: Optional["TransportFaults"] = None
    #: Gossip tier summaries (requires ``topology``): cross-tier rounds
    #: send one summary row per RootGrid instead of dense per-site
    #: rows (dense rows still flow within a tier). Shrinks cross-tier
    #: gossip from O(sites) to O(tiers) — an at-scale approximation:
    #: cross-tier dense rows stop refreshing, so placement is NOT
    #: bit-identical to dense gossip.
    gossip_summaries: bool = False

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


_P2P_FIELDS = frozenset({
    "num_peers", "exchange_interval_s", "exchange_latency_s",
    "migration_max_staleness_s", "gossip_fanout",
    "gossip_wire", "gossip_quant", "gossip_full_sync_every",
    "transport_faults", "gossip_summaries",
})
_ALL_FIELDS = frozenset(f.name for f in dataclasses.fields(SimConfig))
_BASE_FIELDS = _ALL_FIELDS - _P2P_FIELDS

_warned_legacy = False


def resolve_config(
    config: Optional[SimConfig],
    kw: dict,
    allowed: frozenset,
    owner: str,
) -> SimConfig:
    """Fold legacy keyword arguments into a ``SimConfig``.

    Unknown names raise ``TypeError`` (matching the old explicit
    signatures); any accepted legacy kwarg triggers the once-per-process
    deprecation warning and overrides the corresponding ``config``
    field.
    """
    global _warned_legacy
    unknown = sorted(set(kw) - allowed)
    if unknown:
        raise TypeError(
            f"{owner}() got unexpected keyword argument(s) {unknown}; "
            f"valid SimConfig fields here are {sorted(allowed)}"
        )
    if config is None:
        config = SimConfig()
    if kw:
        if not _warned_legacy:
            _warned_legacy = True
            warnings.warn(
                f"passing simulator options as keyword arguments "
                f"({sorted(kw)}) is deprecated; pass "
                f"{owner}(site_nodes, links, config=SimConfig(...)) instead "
                f"(this warning is emitted once per process)",
                DeprecationWarning,
                stacklevel=3,
            )
        config = dataclasses.replace(config, **kw)
    return config
