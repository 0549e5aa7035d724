"""Site failure + recovery: two sites die mid-run (one while the grid
is loaded, one overlapping) and come back later.

Jobs running on or queued at a dying site are displaced and re-placed
through the §IX migration path over the surviving sites; the verifier
pins that the displacement actually happened (requeued > 0), that
nothing ever completed on a dead site, and that conservation holds
through the churn.
"""
from __future__ import annotations

from ...sim import SimConfig, poisson_source
from ...sim.faults import FaultPlan

from ..common import ScenarioSpec, grid16

PARAMS = {
    "smoke": dict(
        rate_per_s=0.18, duration_s=1200.0, work=240.0,
        down=(("site03", 200.0, 700.0), ("site09", 450.0, 1000.0)),
    ),
    "bench": dict(
        rate_per_s=0.9, duration_s=3600.0, work=240.0,
        down=(("site03", 500.0, 1800.0), ("site09", 1200.0, 2600.0),
              ("site12", 2000.0, 3200.0)),
    ),
}


def generate(scale: str = "smoke", seed: int = 0) -> ScenarioSpec:
    p = dict(PARAMS[scale])
    site_nodes = grid16(nodes=3)
    names = sorted(site_nodes)
    source = poisson_source(
        "batch", rate_per_s=p["rate_per_s"], duration_s=p["duration_s"],
        seed=seed, work=p["work"],
        input_bytes=6e8, output_bytes=6e7,
        data_site=names[3], origin_site=names[0],
    )
    plan = FaultPlan()
    for site, t_down, t_up in p["down"]:
        plan.site_down(t_down, site).site_up(t_up, site)
    config = SimConfig(
        policy="diana",
        migration_interval_s=60.0,
        congestion_window_s=240.0,
        fault_plan=plan,
        retain_jobs=True,
    )
    return ScenarioSpec(
        name="site_failure", scale=scale, site_nodes=site_nodes,
        config=config, jobs=source, params=dict(p, seed=seed),
    )
