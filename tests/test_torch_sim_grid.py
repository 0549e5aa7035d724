"""§XI simulation, ported: ``repro_torch.sim.GridSim`` on the host against
``repro.sim.GridSim`` on the workloads of tests/sim/test_grid_sim.py —
whole traces, timelines and stream statistics bit for bit, under both run
loops — and the reference suite's own behavioural tests on the port
(policy ordering, the arrival-batch fast path, link-table invalidation)."""
import copy
import math

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                      # offline CI: vendored shim
    from _hypothesis_compat import given, settings, strategies as st

import repro.sim as RS
import repro_torch.sim as PS
from _torch_sim_twins import (
    MIGRATING,
    GridSim,
    assert_same_run,
    burst_workload,
    data_heavy_workload,
    overload_workload,
    run_both,
    trace,
)
from repro_torch.sim import interop

POLICIES = ("diana", "greedy", "local", "fcfs")


def _run(policy, jobs, nodes=None, **kw):
    """The port's run of reference-built jobs."""
    sim = GridSim(nodes or PS.paper_grid_spec(), config=PS.SimConfig(policy=policy, **kw))
    return sim.run(interop.jobs_from_reference(jobs))


class TestMatchesReference:
    @pytest.mark.parametrize("horizon", [True, False])
    @pytest.mark.parametrize("policy", POLICIES)
    def test_data_heavy(self, policy, horizon):
        assert_same_run(*run_both(RS.paper_grid_spec(), data_heavy_workload(60),
                                  policy=policy, horizon=horizon))

    @pytest.mark.parametrize("horizon", [True, False])
    @pytest.mark.parametrize("batch_migration", [True, False])
    def test_overload_with_migration(self, horizon, batch_migration):
        ref, port = run_both(RS.paper_grid_spec(), overload_workload(), policy="diana",
                             horizon=horizon, batch_migration=batch_migration, **MIGRATING)
        assert_same_run(ref, port)
        assert port.migrations() == 148

    def test_big_site_imports(self):
        ref, port = run_both(dict(RS.paper_grid_spec(), big=50), overload_workload(),
                             policy="diana", **MIGRATING)
        assert_same_run(ref, port)
        assert sum(port.timeline["big"]["imported"]) > 0

    @pytest.mark.parametrize("batch_arrivals", [True, False])
    def test_bulk_bursts(self, batch_arrivals):
        assert_same_run(*run_both(RS.paper_grid_spec(), burst_workload(), policy="diana",
                                  batch_arrivals=batch_arrivals))

    @pytest.mark.parametrize("policy", POLICIES)
    def test_cms_case_study(self, policy):
        assert_same_run(*run_both(RS.paper_grid_spec(), RS.cms_case_study(scale=0.3, seed=4),
                                  policy=policy))


# -- the reference suite's behaviour, on the port -------------------------------

def test_all_jobs_complete_every_policy():
    jobs = data_heavy_workload(60)
    for policy in POLICIES:
        res = _run(policy, jobs)
        assert all(j.finish >= 0 for j in res.jobs), policy
        assert res.makespan > 0


def test_determinism():
    jobs = data_heavy_workload(50)
    r1, r2 = _run("diana", jobs), _run("diana", jobs)
    assert trace(r1) == trace(r2)


def test_diana_beats_baselines_on_data_heavy():
    jobs = data_heavy_workload(120)
    t = {p: _run(p, jobs).avg_turnaround for p in POLICIES}
    assert t["diana"] <= min(t["greedy"], t["fcfs"], t["local"])
    diana = _run("diana", jobs)
    assert sum(1 for j in diana.jobs if j.exec_site == "site3") > len(jobs) * 0.4


def test_queue_time_grows_with_job_count():
    qts = []
    for n in (25, 100, 400):
        jobs = RS.bulk_burst("u0", n, at=0.0, work=60.0, input_bytes=0.0,
                             data_site="site1", origin_site="site1")
        qts.append(_run("diana", jobs).avg_queue_time)
    assert qts[0] <= qts[1] <= qts[2] and qts[2] > qts[0]


def test_overloaded_site_exports_and_pins():
    res = _run("diana", overload_workload(), **MIGRATING)
    exported = sum(sum(res.timeline[s]["exported"]) for s in res.timeline)
    assert exported == sum(sum(res.timeline[s]["imported"]) for s in res.timeline) > 0
    migrated = [j for j in res.jobs if j.migrated]
    assert migrated and all(j.finish >= 0 for j in migrated)


def test_fcfs_baseline_single_queue():
    res = _run("fcfs", RS.bulk_burst("u", 30, at=0.0, work=10.0, input_bytes=0.0))
    starts = [j.start for j in res.jobs]
    assert all(j.finish >= 0 for j in res.jobs) and starts == sorted(starts)


def test_sim_holding_tensors_deep_copies():
    """The migration bench and the equivalence tests deep-copy sims."""
    sim = GridSim(PS.paper_grid_spec(), config=PS.SimConfig(policy="diana", **MIGRATING))
    sim.choose_sites_batch(interop.jobs_from_reference(burst_workload()[:20]))
    assert sim._loss is not None and sim._static_row_cache
    twin = copy.deepcopy(sim)
    assert twin._loss is not sim._loss and torch.equal(twin._loss, sim._loss)
    jobs = interop.jobs_from_reference(overload_workload())
    assert trace(twin.run(copy.deepcopy(jobs))) == trace(sim.run(copy.deepcopy(jobs)))


class TestArrivalBatchFastPath:
    """The vectorized same-instant arrival path ≡ per-arrival processing."""

    def _compare(self, jobs, **kw):
        seq = _run("diana", jobs, batch_arrivals=False, **kw)
        bat = _run("diana", jobs, batch_arrivals=True, **kw)
        assert trace(seq) == trace(bat)

    def test_bulk_bursts_identical(self):
        self._compare(burst_workload())

    def test_with_quotas_and_migration_identical(self):
        self._compare(overload_workload(), **MIGRATING)

    @pytest.mark.parametrize("policy", POLICIES)
    def test_choose_sites_batch_matches_choose_site_snapshot(self, policy):
        jobs = interop.jobs_from_reference(burst_workload())
        sim = GridSim(PS.paper_grid_spec(), config=PS.SimConfig(policy=policy))
        assert sim.choose_sites_batch(jobs) == [sim.choose_site(j) for j in jobs]
        ref = RS.GridSim(RS.paper_grid_spec(), config=RS.SimConfig(policy=policy))
        assert sim.choose_sites_batch(jobs) == ref.choose_sites_batch(burst_workload())

    def test_off_grid_job_endpoints_fall_back_to_sequential(self):
        links = PS.uniform_links(["site1", "site2", "storage"])
        nodes = {"site1": 2, "site2": 2}
        jobs = RS.bulk_burst("u", 10, at=0.0, work=5.0, input_bytes=2e9,
                             data_site="storage", origin_site="site1")
        bat = GridSim(nodes, links=links, config=PS.SimConfig(batch_arrivals=True)).run(
            interop.jobs_from_reference(jobs))
        seq = GridSim(nodes, links=dict(links), config=PS.SimConfig(batch_arrivals=False)).run(
            interop.jobs_from_reference(jobs))
        assert all(j.finish >= 0 for j in bat.jobs) and trace(bat) == trace(seq)
        ref, port = run_both(nodes, jobs, links=RS.uniform_links(["site1", "site2", "storage"]))
        assert_same_run(ref, port)

    def test_assigning_links_invalidates_static_cache(self):
        sim = GridSim(PS.paper_grid_spec(), config=PS.SimConfig())
        jobs = interop.jobs_from_reference(RS.bulk_burst(
            "u", 5, at=0.0, work=5.0, input_bytes=1e9, data_site="site3", origin_site="site1"))
        sim.choose_sites_batch(jobs)
        assert sim._static_row_cache
        sim.links = PS.uniform_links(list(PS.paper_grid_spec()), bandwidth_Bps=1e7)
        assert not sim._static_row_cache and sim._loss is None
        sim.choose_sites_batch(jobs)
        assert sim._static_row_cache

    def test_full_link_table_reenables_disabled_fast_path(self):
        names = list(PS.paper_grid_spec())
        partial = {k: v for k, v in PS.uniform_links(names).items() if "site1" in k or k[0] == k[1]}
        sim = GridSim(PS.paper_grid_spec(), links=partial, config=PS.SimConfig(batch_arrivals=True))
        assert not sim._link_matrices_ready() and sim.batch_arrivals is False
        sim.links = PS.uniform_links(names)
        assert sim.batch_arrivals is True and sim._link_matrices_ready()

    def test_partial_link_table_falls_back_to_sequential(self):
        names = ["site1", "site2", "site3"]
        links = {k: v for k, v in RS.uniform_links(names).items() if "site1" in k or k[0] == k[1]}
        jobs = RS.bulk_burst("u", 20, at=0.0, work=5.0, input_bytes=1e9,
                             data_site="site1", origin_site="site1")
        ref, port = run_both({n: 2 for n in names}, jobs, links=links)
        assert_same_run(ref, port)
        assert all(j.finish >= 0 for j in port.jobs)


class TestLinkInvalidationProperty:
    """Any link-table mutation followed by a placement ≡ a sim built from
    scratch on the same table, and ≡ the reference."""

    @staticmethod
    def _random_links(names, rng):
        links = {}
        for a in names:
            for b in names:
                if a == b:
                    links[(a, b)] = RS.uniform_links([a])[(a, a)]
                else:
                    links[(a, b)] = RS.uniform_links(
                        [a, b], bandwidth_Bps=float(rng.uniform(1e8, 5e9)),
                        loss_rate=float(rng.uniform(1e-4, 0.02)))[(a, b)]
        return links

    @staticmethod
    def _batch(names, rng, n=25):
        jobs = []
        for i in range(n):
            jobs.extend(RS.bulk_burst(
                f"u{i % 3}", 1, at=0.0, work=float(rng.uniform(5, 200)),
                input_bytes=float(rng.uniform(0, 5e9)), output_bytes=float(rng.uniform(0, 5e8)),
                data_site=names[int(rng.integers(len(names)))],
                origin_site=names[int(rng.integers(len(names)))]))
        return jobs

    @given(seed=st.integers(0, 10_000), via_setter=st.booleans())
    @settings(max_examples=15, deadline=None)
    def test_placement_after_invalidation_matches_fresh_sim(self, seed, via_setter):
        rng = np.random.default_rng(seed)
        nodes = PS.paper_grid_spec()
        names = sorted(nodes)
        sim = GridSim(nodes, config=PS.SimConfig())
        sim.choose_sites_batch(interop.jobs_from_reference(self._batch(names, rng)))
        assert sim._static_row_cache
        new_links = self._random_links(names, rng)
        port_links = interop.links_from_reference(new_links)
        if via_setter:
            sim.links = port_links
        else:
            sim.links.clear()
            sim.links.update(port_links)
            sim.invalidate_links()
        assert not sim._static_row_cache
        probe = self._batch(names, rng)
        fresh = GridSim(nodes, links=dict(port_links), config=PS.SimConfig())
        got = sim.choose_sites_batch(interop.jobs_from_reference(probe))
        assert got == fresh.choose_sites_batch(interop.jobs_from_reference(probe))
        ref = RS.GridSim(nodes, links=dict(new_links), config=RS.SimConfig())
        assert got == ref.choose_sites_batch(copy.deepcopy(probe))


class TestArgminCorners:
    """The sim's row argmins are NumPy's: first index on ties, a NaN row
    entry wins (degenerate links), an all-inf row answers column 0."""

    def test_ties_nan_and_dead_rows(self):
        names = ["a", "b", "c", "d"]
        links = RS.uniform_links(names)
        links[("a", "c")] = RS.uniform_links(["a", "c"], bandwidth_Bps=float("nan"))[("a", "c")]
        jobs = RS.bulk_burst("u", 12, at=0.0, work=5.0, input_bytes=1e9,
                             data_site="a", origin_site="a")
        jobs += RS.bulk_burst("u", 12, at=1.0, work=5.0, input_bytes=0.0,
                              data_site="b", origin_site="b")
        ref, port = run_both({n: 1 for n in names}, jobs, links=links, horizon=True)
        assert_same_run(ref, port)
        # The per-event loop meets the NaN service time of a job placed
        # over the NaN link when it buckets its finish: both packages
        # stop there alike.
        with pytest.raises(ValueError, match="NaN"):
            run_both({n: 1 for n in names}, jobs, links=links, horizon=False)
        with pytest.raises(ValueError, match="NaN"):
            GridSim({n: 1 for n in names}, links=interop.links_from_reference(links),
                    config=PS.SimConfig(horizon=False)).run(interop.jobs_from_reference(jobs))

    def test_all_sites_tie(self):
        jobs = RS.bulk_burst("u", 9, at=0.0, work=5.0, input_bytes=0.0, output_bytes=0.0,
                             data_site=None, origin_site="s2")
        ref, port = run_both({f"s{i}": 1 for i in range(4)}, jobs,
                             links=RS.uniform_links([f"s{i}" for i in range(4)], loss_rate=0.0,
                                                    bandwidth_Bps=1e9, local_bandwidth_Bps=1e9))
        assert_same_run(ref, port)
        assert math.isfinite(port.makespan)
