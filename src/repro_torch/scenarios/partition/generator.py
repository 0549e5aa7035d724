"""Split-brain partition: the WAN trunk between two RootGrid tiers is
severed mid-run, then heals.

Sites alternate between a *north* and a *south* tier (by index
parity, so the peer homes — the first N sorted sites — split across
both tiers and the gossip hierarchy genuinely bridges the cut).
During the partition window no gossip message crosses tiers: each
half keeps scheduling on its own (increasingly stale) picture of the
other half, the phi-accrual detectors push cross-tier peers into
suspicion, retransmissions back off until they escalate to forced
full syncs, and placement/migration fall back to tier-local,
owner-direct knowledge. While the brain is split, a south site dies
and recovers — the north half can't learn about it until the heal,
so its stale submissions must bounce off the authoritative grid.

The verifier pins the heal: every peer's view reconverges after the
window closes, the settled views equal the no-partition twin's,
nothing ever completes on the dead site, and the episode's makespan
cost stays bounded.
"""
from __future__ import annotations

import dataclasses

from ...core import GridTopology, Node
from ...sim import SimConfig, poisson_source
from ...sim.faults import FaultPlan, PartitionWindow, TransportFaults

from ..common import ScenarioSpec, grid16

PARAMS = {
    "smoke": dict(
        rate_per_s=0.2, duration_s=1500.0, work=200.0,
        num_peers=4, exchange_interval_s=60.0, exchange_latency_s=5.0,
        t_split=300.0, t_heal=900.0,
        t_site_down=420.0, t_site_up=1020.0, dead_site_idx=5,
    ),
    "bench": dict(
        rate_per_s=0.8, duration_s=3600.0, work=200.0,
        num_peers=4, exchange_interval_s=60.0, exchange_latency_s=5.0,
        t_split=600.0, t_heal=1800.0,
        t_site_down=700.0, t_site_up=2000.0, dead_site_idx=5,
    ),
}


def tier_map(names) -> dict[str, str]:
    """Index-parity tiers: even sorted positions north, odd south —
    this interleaves the peer homes across the cut."""
    return {
        n: ("north" if i % 2 == 0 else "south")
        for i, n in enumerate(sorted(names))
    }


def generate(scale: str = "smoke", seed: int = 0) -> ScenarioSpec:
    p = dict(PARAMS[scale])
    site_nodes = grid16(nodes=3)
    names = sorted(site_nodes)
    tiers = tier_map(names)

    topo = GridTopology()
    for n in names:
        topo.join(tiers[n], Node(name=n))

    dead_site = names[p["dead_site_idx"]]
    assert tiers[dead_site] == "south"  # dies on the far side of the cut

    source = poisson_source(
        "vo", rate_per_s=p["rate_per_s"], duration_s=p["duration_s"],
        seed=seed, work=p["work"],
        input_bytes=6e8, output_bytes=6e7,
        data_site=names[4], origin_site=names[0],
    )
    window = PartitionWindow(
        start=p["t_split"], end=p["t_heal"],
        groups=(
            frozenset(n for n in names if tiers[n] == "north"),
            frozenset(n for n in names if tiers[n] == "south"),
        ),
    )
    faults = TransportFaults(seed=seed + 1, partitions=(window,))
    plan = (
        FaultPlan()
        .site_down(p["t_site_down"], dead_site)
        .site_up(p["t_site_up"], dead_site)
    )
    config = SimConfig(
        policy="diana",
        migration_interval_s=60.0,
        congestion_window_s=240.0,
        num_peers=p["num_peers"],
        exchange_interval_s=p["exchange_interval_s"],
        exchange_latency_s=p["exchange_latency_s"],
        topology=topo,
        gossip_wire="delta",
        transport_faults=faults,
        fault_plan=plan,
        retain_jobs=True,
    )
    return ScenarioSpec(
        name="partition", scale=scale, site_nodes=site_nodes,
        config=config, jobs=source, p2p=True,
        params=dict(p, seed=seed, dead_site=dead_site),
    )


def no_partition_twin(spec: ScenarioSpec) -> ScenarioSpec:
    """The identical deployment, workload and site outage with the
    trunk intact — isolates what the split-brain itself costs."""
    return dataclasses.replace(
        spec, config=spec.config.replace(transport_faults=None),
    )
