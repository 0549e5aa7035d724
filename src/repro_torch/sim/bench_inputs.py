"""The inputs of the repo's simulator benchmarks, over either package.

Each function rebuilds one generator of ``benchmarks/*.py`` (which import
the reference) with the same NumPy draws in the same order, over the
classes of the modules it is given: ``sim_mod``/``core_mod`` default to
this port's ``repro_torch.sim``/``repro_torch.core`` and may be the
reference's ``repro.sim``/``repro.core`` instead, which is how the tests
hold these copies to the benchmarks'. ``chip_smoke.py`` drives the port's
simulator on the card with them.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "QUOTAS", "fig78_workload", "overload_workload", "congested_sim",
    "migration_snapshot", "streaming_grid", "streaming_workload",
    "hier_sim_grid", "hier_core_grid", "p2p_grid", "p2p_workload",
]

#: The benchmarks' quotas: a low-quota flood behind a high-quota stream.
QUOTAS = {"hog": 10.0, "polite": 1000.0}


def _sim(sim_mod):
    if sim_mod is None:
        import repro_torch.sim as sim_mod
    return sim_mod


def _core(core_mod):
    if core_mod is None:
        import repro_torch.core as core_mod
    return core_mod


def fig78_workload(n: int, seed: int = 0, *, sim_mod=None) -> list:
    """benchmarks/fig7_8_queue_exec.py:_workload."""
    S = _sim(sim_mod)
    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(n):
        jobs.extend(S.bulk_burst(
            user=f"u{i % 5}", n=1, at=float(i * 1.5), work=30.0, input_bytes=4e9,
            output_bytes=2e8, data_site=f"site{(i % 3) + 2}", origin_site="site1", rng=rng))
    return jobs


def overload_workload(n_bursts: int = 6, burst: int = 40, *, sim_mod=None) -> list:
    """benchmarks/fig9_11_migration.py:_overload: a low-quota hog flood
    behind a high-quota polite stream (Q4 jobs, congested sites, §IX
    migration)."""
    S = _sim(sim_mod)
    jobs = []
    for b in range(n_bursts):
        jobs.extend(S.bulk_burst("hog", burst, at=float(b * 30), work=300.0, input_bytes=2e9,
                                 data_site="site1", origin_site="site1"))
    for i in range(40):
        jobs.extend(S.bulk_burst("polite", 1, at=float(i * 20), work=300.0, input_bytes=2e9,
                                 data_site="site1", origin_site="site1"))
    return sorted(jobs, key=lambda j: j.arrival)


def congested_sim(jobs: int, sites: int, seed: int = 0, *, sim_mod=None, core_mod=None,
                  device=None, **cfg):
    """benchmarks/migration_bench.py:_congested_sim: every site's queue
    backed up with a Q4-heavy backlog and congested. ``cfg`` adds
    ``SimConfig`` fields (``placement``, ``batch_migration``, ...);
    ``device`` is passed to the port's ``GridSim`` when given. Returns
    ``(sim, now)``."""
    S, P = _sim(sim_mod), _core(core_mod)
    rng = np.random.default_rng(seed)
    names = [f"s{i:03d}" for i in range(sites)]
    config = S.SimConfig(policy="diana", quotas=dict(QUOTAS), migration_interval_s=60.0,
                         congestion_window_s=300.0, **cfg)
    extra = {} if device is None else {"device": device}
    sim = S.GridSim({n: 2 for n in names}, config=config, **extra)
    now = 100.0
    for k in range(jobs):
        name = names[k % sites]
        user = "polite" if (k // sites) < 4 else "hog"
        work = float(rng.uniform(50.0, 500.0))
        sj = S.SimJob(user=user, arrival=now, work=work, input_bytes=float(rng.uniform(0, 5e9)),
                      output_bytes=float(rng.uniform(0, 5e8)),
                      data_site=names[int(rng.integers(sites))],
                      origin_site=names[int(rng.integers(sites))])
        cj = P.Job(user=user, t=1.0, submit_time=now, compute_work=sj.work,
                   input_bytes=sj.input_bytes, output_bytes=sj.output_bytes)
        sim._cj2sj[cj.job_id] = sj
        sj.exec_site = name
        site = sim.sites[name]
        if site.busy < site.nodes:
            site.busy += 1
            site.running_work += sj.work
        else:
            site.enqueue(cj, now=now)
    return sim, now


def migration_snapshot(sim) -> dict:
    """benchmarks/migration_bench.py:_snapshot, keyed by job ordinal (the
    order jobs entered the sim): job ids come from a per-package counter,
    so raw ids differ between sims."""
    order = {jid: k for k, jid in enumerate(sim._cj2sj)}
    return {
        "exported": {s: sum(sim.timeline[s]["exported"]) for s in sim.timeline},
        "imported": {s: sum(sim.timeline[s]["imported"]) for s in sim.timeline},
        "moves": [(sj.exec_site, sj.migrated) for sj in sim._cj2sj.values()],
        "queues": {n: sorted(order[j.job_id] for j in s.mlfq.jobs) for n, s in sim.sites.items()},
    }


def streaming_grid(sites: int) -> dict:
    """benchmarks/streaming_bench.py:_grid: nodes of 4/8/12."""
    return {f"s{i:04d}": (4, 8, 12)[i % 3] for i in range(sites)}


def streaming_workload(names: list, jobs: int, seed: int = 0, *, sim_mod=None) -> list:
    """benchmarks/streaming_bench.py:_reference_workload: bursts from
    random origins and a Poisson tail."""
    S = _sim(sim_mod)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(max(1, jobs * 3 // 16)):
        origin = names[int(rng.integers(len(names)))]
        out.extend(S.bulk_burst(f"u{i % 8}", 4, at=float(i * 2), work=300.0, input_bytes=0.0,
                                output_bytes=0.0, data_site=None, origin_site=origin, rng=rng,
                                work_jitter=0.3))
    tail = S.poisson_stream("tail", 1.0, float(jobs // 4), seed=seed + 1, work=90.0,
                            input_bytes=0.0, output_bytes=0.0, data_site=None,
                            origin_site=names[0])
    out.extend(tail[: max(0, jobs - len(out))])
    return sorted(out, key=lambda j: j.arrival)


def hier_sim_grid(n_sites: int, tiers_n: int, seed: int, *, sim_mod=None, core_mod=None):
    """benchmarks/hier_bench.py:_build_sim: (nodes, links, topology, jobs)."""
    S, P = _sim(sim_mod), _core(core_mod)
    rng = np.random.default_rng(seed)
    names = [f"s{i:04d}" for i in range(n_sites)]
    spec = {n: int(rng.integers(1, 5)) for n in names}
    tier_bw = rng.uniform(1e7, 1e9, tiers_n)
    tier_loss = rng.uniform(0.0, 0.02, tiers_n)
    links = {}
    for a_i, a in enumerate(names):
        ta = a_i % tiers_n
        for b_i, b in enumerate(names):
            tb = b_i % tiers_n
            links[(a, b)] = P.NetworkLink(
                bandwidth_Bps=float(min(tier_bw[ta], tier_bw[tb]) * rng.uniform(0.8, 1.25)),
                loss_rate=0.0 if a == b else float(
                    max(tier_loss[ta], tier_loss[tb]) * rng.uniform(0.8, 1.25)),
                rtt_s=float(rng.uniform(0.01, 0.3)),
            )
    topo = P.GridTopology()
    for i, n in enumerate(names):
        topo.join(f"root{i % tiers_n}", P.Node(name=n))
    jobs = [
        S.SimJob(user=("hog" if i % 5 == 0 else f"u{i % 7}"), arrival=float(i // 8) * 5.0,
                 work=float(rng.integers(10, 600)), input_bytes=float(rng.choice([0.0, 1e6, 5e9])),
                 output_bytes=float(rng.choice([0.0, 2e8])),
                 data_site=(names[i % n_sites] if i % 3 else None),
                 origin_site=names[(i * 7) % n_sites])
        for i in range(800)
    ]
    return spec, links, topo, jobs


def hier_core_grid(sites_n: int, tiers_n: int, jobs_n: int, seed: int = 0, *, core_mod=None):
    """benchmarks/hier_bench.py:_build_core: a tier-structured grid and a
    bulk workload, (sites, links, jobs, tiers)."""
    P = _core(core_mod)
    rng = np.random.default_rng(seed)
    sites, links, tiers = {}, {}, {}
    tier_bw = rng.uniform(1e8, 1e10, tiers_n)
    tier_loss = rng.uniform(1e-4, 0.03, tiers_n)
    tier_rtt = rng.uniform(0.005, 0.3, tiers_n)
    for i in range(sites_n):
        t = i % tiers_n
        n = f"s{i:05d}"
        tiers[n] = f"t{t:03d}"
        sites[n] = P.SiteState(name=n, capacity=float(rng.integers(50, 2000)),
                               queue_length=float(rng.integers(0, 50)),
                               waiting_work=float(rng.uniform(0, 500)),
                               load=float(rng.uniform(0, 1)), alive=bool(rng.uniform() > 0.02))
        links[n] = P.NetworkLink(bandwidth_Bps=float(tier_bw[t] * rng.uniform(0.8, 1.25)),
                                 loss_rate=float(tier_loss[t] * rng.uniform(0.8, 1.25)),
                                 rtt_s=float(tier_rtt[t] * rng.uniform(0.8, 1.25)))
    jobs = [P.Job(user=f"u{i % 7}", compute_work=float(rng.uniform(0.1, 100)),
                  input_bytes=float(rng.uniform(0, 30e9)), output_bytes=float(rng.uniform(0, 2e9)))
            for i in range(jobs_n)]
    return sites, links, jobs, tiers


def p2p_grid(sites: int) -> dict:
    """benchmarks/p2p_bench.py:_grid: capacity-heterogeneous nodes
    (2/4/8)."""
    return {f"s{i:03d}": (2, 4, 8)[i % 3] for i in range(sites)}


def p2p_workload(names: list, jobs: int, seed: int = 0, *, sim_mod=None) -> list:
    """benchmarks/p2p_bench.py:_workload: compute-bound bursts of 4 from
    random origins, no data gravity."""
    S = _sim(sim_mod)
    rng = np.random.default_rng(seed)
    out = []
    burst = 4
    for i in range(max(1, jobs // burst)):
        origin = names[int(rng.integers(len(names)))]
        out.extend(S.bulk_burst(f"u{i % 16}", burst, at=float(i * 3), work=200.0,
                                input_bytes=0.0, output_bytes=0.0, data_site=None,
                                origin_site=origin, rng=rng, work_jitter=0.3))
    return sorted(out, key=lambda j: j.arrival)
