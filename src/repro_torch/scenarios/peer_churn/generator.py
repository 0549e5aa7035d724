"""Peer churn: a decentralized deployment where one scheduler leaves
mid-run and rejoins later.

On leave the departing peer hands its home partition to the next
active peer (``PeerScheduler.handover``/``adopt`` — authoritative
state and epoch continuity move together) and drops out of the gossip
fan-out; on rejoin the partition is handed back and the delta wire's
forced table-bearing full sync rebuilds the joiner's world view. The
verifier pins reconvergence within k gossip rounds (for the delta
*and* the full wire) and that the churn costs at most 5% makespan
against a no-churn twin.
"""
from __future__ import annotations

import dataclasses

from ...sim import SimConfig, poisson_source
from ...sim.faults import FaultPlan

from ..common import ScenarioSpec, grid16

PARAMS = {
    "smoke": dict(
        rate_per_s=0.18, duration_s=1200.0, work=240.0,
        num_peers=4, exchange_interval_s=60.0, exchange_latency_s=5.0,
        leave_peer=1, t_leave=300.0, t_join=800.0,
    ),
    "bench": dict(
        rate_per_s=0.9, duration_s=3600.0, work=240.0,
        num_peers=4, exchange_interval_s=60.0, exchange_latency_s=5.0,
        leave_peer=1, t_leave=800.0, t_join=2400.0,
    ),
}


def generate(scale: str = "smoke", seed: int = 0) -> ScenarioSpec:
    p = dict(PARAMS[scale])
    site_nodes = grid16(nodes=3)
    names = sorted(site_nodes)
    source = poisson_source(
        "vo", rate_per_s=p["rate_per_s"], duration_s=p["duration_s"],
        seed=seed, work=p["work"],
        input_bytes=6e8, output_bytes=6e7,
        data_site=names[5], origin_site=names[0],
    )
    plan = (
        FaultPlan()
        .peer_leave(p["t_leave"], p["leave_peer"])
        .peer_join(p["t_join"], p["leave_peer"])
    )
    config = SimConfig(
        policy="diana",
        migration_interval_s=60.0,
        congestion_window_s=240.0,
        num_peers=p["num_peers"],
        exchange_interval_s=p["exchange_interval_s"],
        exchange_latency_s=p["exchange_latency_s"],
        gossip_wire="delta",
        fault_plan=plan,
        retain_jobs=True,
    )
    return ScenarioSpec(
        name="peer_churn", scale=scale, site_nodes=site_nodes,
        config=config, jobs=source, p2p=True, params=dict(p, seed=seed),
    )


def no_churn_twin(spec: ScenarioSpec) -> ScenarioSpec:
    """The identical deployment and workload with the churn removed —
    the makespan-degradation reference."""
    return dataclasses.replace(
        spec, config=spec.config.replace(fault_plan=FaultPlan()),
    )


def full_wire_twin(spec: ScenarioSpec) -> ScenarioSpec:
    """The same churn scenario on the uncompressed full wire — the
    delta wire's rejoin resync must converge to the same place."""
    return dataclasses.replace(
        spec, config=spec.config.replace(gossip_wire="full"),
    )
