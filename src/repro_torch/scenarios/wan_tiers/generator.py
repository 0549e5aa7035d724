"""Heterogeneous WAN tiers: two RootGrid tiers joined by asymmetric
link planes, with a mid-run degradation of the data-serving plane.

The 16 sites split into an *east* tier (holding the dataset) and a
*west* tier. Intra-tier links are LAN-fast; the east→west plane (the
direction bulk input data travels for a west placement) is an order of
magnitude slower than west→east. Mid-run the east→west plane degrades
further (congested transatlantic window), then restores. The verifier
pins that placements respect the data-cost asymmetry — jobs arriving
during the degraded window stay data-local at least as often as the
rest — and that the link table is restored afterwards.
"""
from __future__ import annotations

from ...core import GridTopology, Node
from ...core.costs import NetworkLink
from ...sim import SimConfig, poisson_source
from ...sim.faults import FaultPlan

from ..common import ScenarioSpec, grid16

PARAMS = {
    "smoke": dict(
        rate_per_s=0.24, duration_s=1200.0, work=150.0,
        t_degrade=300.0, t_restore=800.0,
        degrade_factor=0.1, degrade_loss=3e-4,
        num_peers=4, exchange_interval_s=60.0, exchange_latency_s=5.0,
    ),
    "bench": dict(
        rate_per_s=0.28, duration_s=3600.0, work=150.0,
        t_degrade=900.0, t_restore=2400.0,
        degrade_factor=0.1, degrade_loss=3e-4,
        num_peers=4, exchange_interval_s=60.0, exchange_latency_s=5.0,
    ),
}

LOCAL_BW = 1e10          # site-internal
INTRA_BW = 1e9           # LAN plane within a tier
EAST_TO_WEST_BW = 8e7    # bulk-data direction: slow uplink
WEST_TO_EAST_BW = 2.5e8  # return direction: faster
# Nominal loss keeps the WAN planes below the Mathis TCP ceiling so the
# *bandwidth* asymmetry is what the cost model sees; the scripted
# degradation adds real loss, which slams the effective bandwidth to
# the Mathis floor for the window.
CROSS_LOSS = 1e-7


def tier_map(names) -> dict[str, str]:
    names = sorted(names)
    half = len(names) // 2
    return {n: ("east" if n in names[:half] else "west") for n in names}


def _tiered_links(names) -> dict[tuple[str, str], NetworkLink]:
    tiers = tier_map(names)
    links = {}
    for a in names:
        for b in names:
            if a == b:
                bw, loss = LOCAL_BW, 0.0
            elif tiers[a] == tiers[b]:
                bw, loss = INTRA_BW, 0.0
            elif tiers[a] == "east":
                bw, loss = EAST_TO_WEST_BW, CROSS_LOSS
            else:
                bw, loss = WEST_TO_EAST_BW, CROSS_LOSS
            links[(a, b)] = NetworkLink(bandwidth_Bps=bw, loss_rate=loss)
    return links


def generate(scale: str = "smoke", seed: int = 0) -> ScenarioSpec:
    p = dict(PARAMS[scale])
    site_nodes = grid16(nodes=3)
    names = sorted(site_nodes)
    tiers = tier_map(names)
    east = [n for n in names if tiers[n] == "east"]

    topo = GridTopology()
    for n in names:
        topo.join(tiers[n], Node(name=n))

    source = poisson_source(
        "wan", rate_per_s=p["rate_per_s"], duration_s=p["duration_s"],
        seed=seed, work=p["work"],
        input_bytes=2e9, output_bytes=1e8,
        data_site=east[2], origin_site=east[0],
    )
    cross_plane = tuple(
        (a, b) for a in east for b in names if tiers[b] == "west"
    )
    plan = (
        FaultPlan()
        .link_degrade(p["t_degrade"], pairs=cross_plane,
                      bandwidth_factor=p["degrade_factor"],
                      loss_add=p["degrade_loss"])
        .link_restore(p["t_restore"], pairs=cross_plane)
    )
    config = SimConfig(
        policy="diana",
        migration_interval_s=60.0,
        congestion_window_s=240.0,
        num_peers=p["num_peers"],
        exchange_interval_s=p["exchange_interval_s"],
        exchange_latency_s=p["exchange_latency_s"],
        topology=topo,
        fault_plan=plan,
        retain_jobs=True,
    )
    return ScenarioSpec(
        name="wan_tiers", scale=scale, site_nodes=site_nodes,
        config=config, jobs=source, links=_tiered_links(names),
        p2p=True, params=dict(p, seed=seed, data_tier="east"),
    )
