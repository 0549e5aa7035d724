"""Diurnal flash crowd: a sinusoidal arrival rate with §VIII-style
burst spikes riding the peaks.

No scripted faults — this scenario stresses the schedulers' behavior
under bursty, time-varying load alone (the §XI experiments' missing
dynamic regime), and its baselines pin how turnaround tails respond to
the flash crowds.
"""
from __future__ import annotations

from ...sim import SimConfig, diurnal_source
from ...sim.faults import FaultPlan

from ..common import ScenarioSpec, grid16

PARAMS = {
    "smoke": dict(
        base_rate_per_s=0.16, duration_s=1200.0, amplitude=0.7,
        period_s=600.0, spikes=((150.0, 16), (750.0, 24)),
        work=90.0, input_bytes=4e8, output_bytes=4e7,
    ),
    "bench": dict(
        base_rate_per_s=0.8, duration_s=3600.0, amplitude=0.7,
        period_s=1200.0, spikes=((300.0, 120), (1500.0, 180), (2700.0, 120)),
        work=90.0, input_bytes=4e8, output_bytes=4e7,
    ),
}


def generate(scale: str = "smoke", seed: int = 0) -> ScenarioSpec:
    p = dict(PARAMS[scale])
    site_nodes = grid16(nodes=3)
    names = sorted(site_nodes)
    source = diurnal_source(
        "crowd",
        base_rate_per_s=p["base_rate_per_s"],
        duration_s=p["duration_s"],
        amplitude=p["amplitude"],
        period_s=p["period_s"],
        spikes=p["spikes"],
        seed=seed,
        work=p["work"],
        input_bytes=p["input_bytes"],
        output_bytes=p["output_bytes"],
        data_site=names[2],
        origin_site=names[0],
    )
    config = SimConfig(
        policy="diana",
        migration_interval_s=60.0,
        congestion_window_s=240.0,
        fault_plan=FaultPlan(),
        retain_jobs=True,
    )
    return ScenarioSpec(
        name="diurnal_flash", scale=scale, site_nodes=site_nodes,
        config=config, jobs=source, params=dict(p, seed=seed),
    )
