"""``repro_torch.sim.bench_inputs`` rebuilds the simulator benchmarks'
generators (``benchmarks/*.py``): over the reference's classes each one
gives the benchmark's own inputs value for value, and over the port's
classes the same inputs carried across by ``repro_torch.sim.interop``.
``chip_smoke.py`` drives the card with these copies and holds the
results to the committed ``BENCH_*.json``."""
import dataclasses
import sys
from pathlib import Path

import pytest

import repro.core as R
import repro.sim as RS
import repro_torch.core as P
import repro_torch.sim as PS
from repro_torch.sim import bench_inputs as BI
from repro_torch.sim import interop

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import fig7_8_queue_exec, fig9_11_migration, hier_bench  # noqa: E402
from benchmarks import migration_bench, p2p_bench, streaming_bench  # noqa: E402


def _fields(x, drop=("job_id",)):
    return {k: v for k, v in dataclasses.asdict(x).items() if k not in drop}


def _jobs(jobs):
    return [_fields(j) for j in jobs]


def _topology(topo):
    return {rn: {sn: list(sg.nodes) for sn, sg in r.subgrids.items()}
            for rn, r in topo.rootgrids.items()}


@pytest.mark.parametrize("n", [25, 250])
def test_fig78_workload_is_the_benchmarks(n):
    ref = fig7_8_queue_exec._workload(n)
    assert BI.fig78_workload(n, sim_mod=RS) == ref
    assert _jobs(BI.fig78_workload(n)) == _jobs(interop.jobs_from_reference(ref))


def test_overload_workload_is_the_benchmarks():
    ref = fig9_11_migration._overload()
    assert BI.overload_workload(sim_mod=RS) == ref
    assert _jobs(BI.overload_workload()) == _jobs(interop.jobs_from_reference(ref))


@pytest.mark.parametrize("seed", [0, 3])
def test_congested_sim_is_the_benchmarks(seed):
    bench, now = migration_bench._congested_sim(600, 24, seed)
    ours, now2 = BI.congested_sim(600, 24, seed, sim_mod=RS, core_mod=R)
    port, now3 = BI.congested_sim(600, 24, seed, device="cpu")
    assert now == now2 == now3
    assert BI.migration_snapshot(ours) == BI.migration_snapshot(bench)
    assert BI.migration_snapshot(port) == BI.migration_snapshot(bench)
    assert list(ours._cj2sj.values()) == list(bench._cj2sj.values())
    assert _jobs(port._cj2sj.values()) == _jobs(bench._cj2sj.values())
    assert ours.config == bench.config
    assert interop.config_from_reference(bench.config) == port.config


def test_streaming_workload_is_the_benchmarks():
    names = sorted(streaming_bench._grid(16))
    assert BI.streaming_grid(16) == streaming_bench._grid(16)
    ref = streaming_bench._reference_workload(names, 400)
    assert BI.streaming_workload(names, 400, sim_mod=RS) == ref
    assert _jobs(BI.streaming_workload(names, 400)) == _jobs(interop.jobs_from_reference(ref))


def test_hier_sim_grid_is_the_benchmarks():
    spec, links, topo, jobs = hier_bench._build_sim(24, 4, 0)
    o_spec, o_links, o_topo, o_jobs = BI.hier_sim_grid(24, 4, 0, sim_mod=RS, core_mod=R)
    assert (o_spec, o_links, o_jobs) == (spec, links, jobs)
    assert _topology(o_topo) == _topology(topo)
    p_spec, p_links, p_topo, p_jobs = BI.hier_sim_grid(24, 4, 0)
    assert p_spec == spec
    assert p_links == interop.links_from_reference(links)
    assert _topology(p_topo) == _topology(interop.topology_from_reference(topo))
    assert isinstance(p_topo, P.GridTopology) and isinstance(p_jobs[0], PS.SimJob)
    assert _jobs(p_jobs) == _jobs(interop.jobs_from_reference(jobs))


def test_hier_core_grid_is_the_benchmarks():
    sites, links, jobs, tiers = hier_bench._build_core(300, 12, 200)
    o_sites, o_links, o_jobs, o_tiers = BI.hier_core_grid(300, 12, 200, core_mod=R)
    assert (o_sites, o_links, o_tiers) == (sites, links, tiers)
    assert _jobs(o_jobs) == _jobs(jobs)
    p_sites, p_links, p_jobs, p_tiers = BI.hier_core_grid(300, 12, 200)
    assert p_tiers == tiers
    assert [_fields(s) for s in p_sites.values()] == [_fields(s) for s in sites.values()]
    assert [_fields(x) for x in p_links.values()] == [_fields(x) for x in links.values()]
    assert _jobs(p_jobs) == _jobs(jobs)


@pytest.mark.parametrize("sites,jobs,seed", [(16, 200, 0), (32, 800, 3)])
def test_p2p_workload_is_the_benchmarks(sites, jobs, seed):
    assert BI.p2p_grid(sites) == p2p_bench._grid(sites)
    names = sorted(p2p_bench._grid(sites))
    ref = p2p_bench._workload(names, jobs, seed)
    assert BI.p2p_workload(names, jobs, seed, sim_mod=RS) == ref
    assert _jobs(BI.p2p_workload(names, jobs, seed)) == _jobs(interop.jobs_from_reference(ref))
