"""Shared helpers of the ported simulator's tests (tests/test_torch_sim_*.py):
the reference's workloads from tests/sim/test_grid_sim.py, and runs of
one workload through ``repro.sim.GridSim`` and ``repro_torch.sim.GridSim``
(on the host) with the inputs carried across by ``repro_torch.sim.interop``."""
import copy
import functools
import warnings

import numpy as np

import repro.sim as RS
import repro_torch.sim as PS
from repro_torch.sim import bench_inputs, interop
from repro_torch.sim.bench_inputs import migration_snapshot  # noqa: F401

CPU = "cpu"
QUOTAS = bench_inputs.QUOTAS
MIGRATING = dict(quotas=QUOTAS, migration_interval_s=30.0, congestion_window_s=120.0)

#: The port's GridSim on the host (the tests' device).
GridSim = functools.partial(PS.GridSim, device=CPU)


def data_heavy_workload(n=120, seed=0):
    """Jobs submitted at site1 whose data lives on site3."""
    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(n):
        jobs.extend(RS.bulk_burst(
            user=f"u{i % 4}", n=1, at=float(i * 2), work=30.0, input_bytes=5e9,
            output_bytes=1e8, data_site="site3", origin_site="site1", rng=rng))
    return jobs


def overload_workload():
    """A low-quota hog flood behind a high-quota polite stream: Q4 jobs,
    congested sites and §IX migration (the reference's jobs)."""
    return bench_inputs.overload_workload(sim_mod=RS)


def burst_workload():
    rng = np.random.default_rng(7)
    jobs = []
    for b in range(5):
        jobs.extend(RS.bulk_burst(f"u{b % 2}", 40, at=float(b * 40), work=80.0,
                                  input_bytes=4e9, output_bytes=2e8, data_site="site3",
                                  origin_site="site1", rng=rng, work_jitter=0.3))
    return sorted(jobs, key=lambda j: j.arrival)


def seeded_workload(seed):
    """TestBatchedMigration's mixed origins and data sites."""
    rng = np.random.default_rng(seed)
    sites = list(RS.paper_grid_spec())
    jobs = []
    for b in range(8):
        jobs.extend(RS.bulk_burst(
            "hog", 25, at=float(b * 25), work=float(rng.uniform(100, 400)),
            input_bytes=float(rng.uniform(0, 3e9)), output_bytes=float(rng.uniform(0, 3e8)),
            data_site=sites[int(rng.integers(len(sites)))],
            origin_site=sites[int(rng.integers(len(sites)))], rng=rng, work_jitter=0.2))
    for i in range(30):
        jobs.extend(RS.bulk_burst(
            "polite", 1, at=float(i * 15), work=200.0, input_bytes=1e9,
            data_site=sites[int(rng.integers(len(sites)))],
            origin_site=sites[int(rng.integers(len(sites)))]))
    return sorted(jobs, key=lambda j: j.arrival)


def trace(result):
    """Everything a run decided, per job in the caller's order (never
    raw job ids: each package numbers its Jobs from its own counter)."""
    return [(j.user, j.arrival, j.work, j.exec_site, j.queue_enter, j.start, j.finish,
             j.migrated, j.requeues) for j in result.jobs]


def run_both(nodes, jobs, links=None, **cfg):
    """One workload through both simulators: (reference result, port
    result). Each gets its own copies of the jobs and link table."""
    config = RS.SimConfig(**cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = RS.GridSim(dict(nodes), links=None if links is None else dict(links),
                         config=copy.deepcopy(config)).run(copy.deepcopy(jobs))
        port = GridSim(dict(nodes),
                       links=None if links is None else interop.links_from_reference(links),
                       config=interop.config_from_reference(config)).run(
            interop.jobs_from_reference(jobs))
    return ref, port


def stats_dict(stats):
    """A ``StreamStats`` of either package as plain values."""
    out = {}
    for k, v in vars(stats).items():
        out[k] = {a: getattr(v, a) for a in v.__slots__} if hasattr(v, "counts") else v
    return out


def assert_same_run(ref, port):
    """Identical runs; the float summaries compare through ``repr`` so
    that a NaN (a degenerate link's service time) equals a NaN."""
    assert repr(trace(port)) == repr(trace(ref))
    assert port.timeline == ref.timeline
    assert repr(stats_dict(port.stats)) == repr(stats_dict(ref.stats))
    summary = lambda r: repr((r.avg_queue_time, r.avg_exec_time, r.avg_turnaround,  # noqa: E731
                              r.makespan, r.finished, r.migrations()))
    assert summary(port) == summary(ref)


def congested_sim(mod_sim, mod_core, jobs, sites, seed=0, **cfg):
    """benchmarks/migration_bench.py:_congested_sim over either package's
    classes (``mod_sim``/``mod_core``: ``repro.sim``/``repro.core`` or
    the port's): the same draws in the same order. The port's sim runs
    on the host."""
    extra = {"device": CPU} if mod_sim is PS else {}
    return bench_inputs.congested_sim(jobs, sites, seed, sim_mod=mod_sim, core_mod=mod_core,
                                      **extra, **cfg)
