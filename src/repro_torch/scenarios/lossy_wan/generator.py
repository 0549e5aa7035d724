"""Lossy WAN: the gossip mesh runs over an unreliable transport —
iid packet loss with a Gilbert–Elliott burst layer, duplication and
reorder jitter — while the workload keeps arriving.

This is the transport-robustness scenario: the delta wire must keep
the peers' world views converging through retransmission, duplicate
suppression and (when a pair's retries exhaust) forced full-sync
escalation. The verifier pins that the lossy run still drains every
job, that every peer's view reconverges to the owners' authoritative
content within a few extra gossip rounds *under continuing loss*,
that the settled views equal the lossless twin's (loss may delay
knowledge but must not corrupt it) and the full-wire twin's (both
wires degrade to the same place), and that the whole ordeal costs at
most 5% makespan against the lossless twin.

The bench scale is the acceptance configuration: 256 sites × 8 peers
under 10% iid loss + 2% duplication + reorder jitter.
"""
from __future__ import annotations

import dataclasses

from ...sim import SimConfig, poisson_source
from ...sim.faults import FaultPlan, TransportFaults

from ..common import ScenarioSpec, grid16

PARAMS = {
    "smoke": dict(
        sites=16, nodes=3, rate_per_s=0.24, duration_s=1200.0, work=200.0,
        num_peers=4, exchange_interval_s=60.0, exchange_latency_s=5.0,
        loss=0.10, duplicate=0.02, reorder_jitter_s=4.0,
        burst_p=0.05, burst_r=0.5, burst_loss=0.6, corrupt=0.01,
    ),
    "bench": dict(
        sites=256, nodes=3, rate_per_s=1.2, duration_s=1800.0, work=200.0,
        num_peers=8, exchange_interval_s=60.0, exchange_latency_s=5.0,
        loss=0.10, duplicate=0.02, reorder_jitter_s=4.0,
        burst_p=0.0, burst_r=0.5, burst_loss=1.0, corrupt=0.0,
    ),
}


def grid_n(sites: int, nodes: int) -> dict[str, int]:
    if sites == 16:
        return grid16(nodes=nodes)
    return {f"site{i:03d}": nodes for i in range(sites)}


def generate(scale: str = "smoke", seed: int = 0) -> ScenarioSpec:
    p = dict(PARAMS[scale])
    site_nodes = grid_n(p["sites"], p["nodes"])
    names = sorted(site_nodes)
    source = poisson_source(
        "wan", rate_per_s=p["rate_per_s"], duration_s=p["duration_s"],
        seed=seed, work=p["work"],
        input_bytes=6e8, output_bytes=6e7,
        data_site=names[5], origin_site=names[0],
    )
    faults = TransportFaults(
        seed=seed + 1,
        loss=p["loss"], duplicate=p["duplicate"],
        reorder_jitter_s=p["reorder_jitter_s"],
        burst_p=p["burst_p"], burst_r=p["burst_r"],
        burst_loss=p["burst_loss"], corrupt=p["corrupt"],
    )
    config = SimConfig(
        policy="diana",
        migration_interval_s=60.0,
        congestion_window_s=240.0,
        num_peers=p["num_peers"],
        exchange_interval_s=p["exchange_interval_s"],
        exchange_latency_s=p["exchange_latency_s"],
        gossip_wire="delta",
        transport_faults=faults,
        fault_plan=FaultPlan(),
        retain_jobs=True,
    )
    return ScenarioSpec(
        name="lossy_wan", scale=scale, site_nodes=site_nodes,
        config=config, jobs=source, p2p=True, params=dict(p, seed=seed),
    )


def lossless_twin(spec: ScenarioSpec) -> ScenarioSpec:
    """The identical deployment and workload on a perfect transport —
    the makespan-degradation and settled-view reference."""
    return dataclasses.replace(
        spec, config=spec.config.replace(transport_faults=None),
    )


def full_wire_twin(spec: ScenarioSpec) -> ScenarioSpec:
    """The same lossy transport under the uncompressed full wire —
    per-round re-flooding must degrade to the same settled views as
    the delta wire's retransmit/escalate machinery."""
    return dataclasses.replace(
        spec, config=spec.config.replace(gossip_wire="full"),
    )
