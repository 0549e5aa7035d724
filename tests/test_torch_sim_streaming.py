"""Event-horizon streaming simulator, ported: the reference suite
(tests/sim/test_streaming.py, minus its multi-scheduler cases) run
against ``repro_torch.sim`` on the host — SimConfig API, ArrivalSource
protocol, horizon ≡ per-event bit-identity, streaming accumulators —
and the port's runs of its own generators' workloads against the
reference's."""
import functools
import warnings

import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # offline container: deterministic shim
    from _hypothesis_compat import given, settings, strategies as st

import repro.sim as RS
import repro_torch.sim as PS
from _torch_sim_twins import assert_same_run
from repro_torch.sim import (
    ArrivalSource,
    ChunkSource,
    JobList,
    SimConfig,
    SimJob,
    StreamingQuantiles,
    bulk_burst,
    cms_case_study,
    paper_grid_spec,
    poisson_source,
    poisson_stream,
    serving_trace_source,
)
from repro_torch.sim.streaming import as_arrival_source

GridSim = functools.partial(PS.GridSim, device="cpu")

NODES = paper_grid_spec()
QUOTAS = {"hog": 10.0, "polite": 1000.0}


def _overload_jobs(seed=9):
    """Migration-heavy reference: a hog flood plus polite traffic."""
    jobs = list(bulk_burst("hog", 60, at=0.0, work=400.0,
                           data_site="site1", origin_site="site1"))
    jobs += list(bulk_burst("polite", 20, at=5.0, work=100.0,
                            data_site="site2", origin_site="site2"))
    jobs += list(poisson_stream("polite", 0.2, 400.0, seed=seed, work=120.0))
    return jobs


def _placements(result):
    return [(j.user, j.arrival, j.exec_site, j.start, j.finish, j.migrated)
            for j in result.jobs]


def _grid(horizon, policy="diana", **kw):
    cfg = SimConfig(policy=policy, quotas=QUOTAS, migration_interval_s=30.0,
                    congestion_window_s=120.0, horizon=horizon, **kw)
    return GridSim(NODES, config=cfg)


# -- SimConfig API ----------------------------------------------------------

class TestSimConfig:
    def test_legacy_kwargs_warn_once_and_match_config(self):
        import repro_torch.sim.config as config_mod
        config_mod._warned_legacy = False
        with pytest.warns(DeprecationWarning, match="deprecated"):
            a = GridSim(NODES, policy="greedy", bucket_s=30.0)
        with warnings.catch_warnings():
            warnings.simplefilter("error")           # second use: silent
            b = GridSim(NODES, policy="greedy", bucket_s=30.0)
        c = GridSim(NODES, config=SimConfig(policy="greedy", bucket_s=30.0))
        assert a.config == b.config == c.config

    def test_unknown_kwarg_raises(self):
        with pytest.raises(TypeError, match="unexpected"):
            GridSim(NODES, polcy="diana")

    def test_p2p_kwarg_rejected_on_base_sim(self):
        with pytest.raises(TypeError):
            GridSim(NODES, num_peers=3)

    def test_replace(self):
        cfg = SimConfig().replace(policy="fcfs", num_peers=5)
        assert cfg.policy == "fcfs" and cfg.num_peers == 5
        assert SimConfig().policy == "diana"          # original untouched

    def test_config_attribute_mirrors(self):
        sim = _grid(True)
        assert sim.policy == "diana"
        assert sim.migration_interval_s == 30.0
        assert sim.config.congestion_window_s == 120.0


# -- ArrivalSource protocol -------------------------------------------------

class TestArrivalSource:
    def test_generators_conform(self):
        assert isinstance(bulk_burst("u", 3), ArrivalSource)
        assert isinstance(poisson_stream("u", 1.0, 10.0), ArrivalSource)
        assert isinstance(poisson_source("u", 1.0, 10.0), ArrivalSource)
        assert isinstance(cms_case_study(scale=0.05), ArrivalSource)
        assert isinstance(JobList(), ArrivalSource)

    def test_as_arrival_source_sorts_plain_lists(self):
        jobs = [SimJob("u", arrival=5.0, work=1.0),
                SimJob("u", arrival=1.0, work=1.0)]
        src = as_arrival_source(jobs)
        chunk = next(iter(src.chunks()))
        assert [j.arrival for j in chunk] == [1.0, 5.0]
        assert jobs[0].arrival == 5.0                  # input list untouched

    def test_as_arrival_source_rejects_non_source(self):
        with pytest.raises(TypeError):
            as_arrival_source(object())

    def test_chunk_source_reiterable(self):
        src = poisson_source("u", 2.0, 50.0, seed=1, chunk_jobs=16)
        a = [j.arrival for c in src.chunks() for j in c]
        b = [j.arrival for c in src.chunks() for j in c]
        assert a == b and len(a) > 16

    def test_out_of_order_chunks_rejected(self):
        src = ChunkSource(lambda: iter([
            [SimJob("u", arrival=10.0, work=1.0)],
            [SimJob("u", arrival=1.0, work=1.0)],
        ]))
        with pytest.raises(ValueError, match="non-decreasing"):
            GridSim(NODES, config=SimConfig()).run(src)

    def test_run_list_equals_run_source(self):
        jobs = _overload_jobs()
        ra = _grid(True).run(list(jobs))
        rb = _grid(True, retain_jobs=True).run(as_arrival_source(list(jobs)))
        # run(list) echoes the caller's order; the collected stream is in
        # admission order — same placements either way
        assert sorted(_placements(ra)) == sorted(_placements(rb))

    def test_poisson_source_equals_poisson_stream(self):
        a = poisson_stream("u", 1.5, 200.0, seed=7, work=30.0)
        b = [j for c in poisson_source("u", 1.5, 200.0, seed=7, work=30.0,
                                       chunk_jobs=13).chunks() for j in c]
        assert [(x.arrival, x.work) for x in a] == [(x.arrival, x.work) for x in b]


# -- horizon ≡ per-event equivalence ---------------------------------------

class TestHorizonEquivalence:
    @pytest.mark.parametrize("policy", ["diana", "greedy", "local", "fcfs"])
    def test_gridsim_bit_identical(self, policy):
        jobs = _overload_jobs()
        ra = _grid(False, policy).run(list(jobs))
        rb = _grid(True, policy).run(list(jobs))
        assert _placements(ra) == _placements(rb)
        assert ra.makespan == rb.makespan

    def test_gridsim_bit_identical_cms(self):
        jobs = cms_case_study(scale=0.3, seed=4)
        ra = _grid(False).run(list(jobs))
        rb = _grid(True).run(list(jobs))
        assert _placements(ra) == _placements(rb)

    def test_eps_window_batches_more_but_completes(self):
        """eps>0 is a documented approximation — not bit-identical, but
        every job must still complete."""
        jobs = poisson_stream("u", 2.0, 100.0, seed=2, work=20.0)
        r = _grid(True, horizon_eps_s=5.0).run(list(jobs))
        assert all(j.finish >= 0 for j in r.jobs)
        assert r.stats.finished == len(jobs)

    @settings(max_examples=10, deadline=None)
    @given(chunk=st.integers(min_value=1, max_value=97))
    def test_chunking_invariance(self, chunk):
        """Property: how the source chunks its stream must not change a
        single placement."""
        base = poisson_stream("u", 1.0, 120.0, seed=11, work=40.0)
        jobs = sorted(base, key=lambda j: j.arrival)

        def chunked():
            for i in range(0, len(jobs), chunk):
                yield [SimJob(user=j.user, arrival=j.arrival, work=j.work,
                              input_bytes=j.input_bytes, output_bytes=j.output_bytes,
                              data_site=j.data_site, origin_site=j.origin_site,
                              group_id=j.group_id)
                       for j in jobs[i:i + chunk]]

        ra = _grid(True).run(list(base))
        rb = _grid(True, retain_jobs=True).run(ChunkSource(chunked))
        assert _placements(ra) == _placements(rb)


# -- streaming accumulators -------------------------------------------------

class TestStreamStats:
    def test_counts_and_peak_in_flight(self):
        jobs = poisson_stream("u", 1.0, 300.0, seed=5, work=90.0)
        r = _grid(True).run(list(jobs))
        s = r.stats
        assert s.admitted == s.finished == len(jobs)
        assert 1 <= s.peak_in_flight <= len(jobs)
        assert s.last_finish == r.makespan

    def test_streaming_mode_retains_no_jobs_by_default(self):
        src = poisson_source("u", 1.0, 300.0, seed=5, work=90.0)
        r = _grid(True).run(src)
        assert r.jobs == []
        assert r.stats.admitted == r.stats.finished > 0
        assert r.throughput > 0 and r.avg_turnaround > 0

    def test_retain_jobs_collects_stream(self):
        src = poisson_source("u", 1.0, 300.0, seed=5, work=90.0)
        r = _grid(True, retain_jobs=True).run(src)
        assert len(r.jobs) == r.stats.admitted > 0

    def test_stream_stats_match_materialized_run(self):
        jobs = poisson_stream("u", 1.0, 300.0, seed=6, work=90.0)
        r_list = _grid(True).run(list(jobs))
        r_src = _grid(True).run(poisson_source("u", 1.0, 300.0, seed=6, work=90.0))
        assert r_list.stats == r_src.stats

    def test_percentiles_close_to_exact(self):
        jobs = poisson_stream("u", 2.0, 500.0, seed=8, work=120.0)
        r = _grid(True).run(list(jobs))
        exact = np.quantile([j.turnaround for j in r.jobs], [0.5, 0.95, 0.99])
        approx = r.turnaround_percentiles()
        for e, a in zip(exact, approx):
            assert abs(a - e) <= 0.05 * max(e, 1e-9)
        # queue-time percentiles exist and are ordered
        q50, q95, q99 = r.queue_time_percentiles()
        assert q50 <= q95 <= q99

    def test_quantile_accumulator_accuracy(self):
        rng = np.random.default_rng(0)
        xs = rng.lognormal(mean=3.0, sigma=1.2, size=20000)
        acc = StreamingQuantiles()
        for x in xs:
            acc.add(float(x))
        for q in (0.5, 0.9, 0.95, 0.99):
            exact = float(np.quantile(xs, q))
            assert abs(acc.quantile(q) - exact) <= 0.03 * exact
        assert acc.n == len(xs)
        assert acc.vmin == xs.min() and acc.vmax == xs.max()

    def test_quantile_edge_cases(self):
        acc = StreamingQuantiles()
        assert acc.quantile(0.5) == 0.0               # empty
        acc.add(0.0)                                   # underflow bucket
        assert acc.quantile(0.5) == 0.0
        acc.add(1e12)                                  # overflow bucket
        assert acc.quantile(1.0) == 1e12


# -- serving-trace adapter --------------------------------------------------

class _FakeRequest:
    """Duck-typed InferenceRequest: the adapter must not need jax."""

    def __init__(self, user, plen, new, at, gid=None):
        self.user = user
        self.prompt = np.arange(plen, dtype=np.int32)
        self.max_new_tokens = new
        self.submit_time = at
        self.group_id = gid


class TestServingTraceSource:
    def test_trace_replays_through_grid(self):
        reqs = [_FakeRequest("tenantA", 8, 4, float(i)) for i in range(40)]
        reqs += [_FakeRequest("tenantB", 16, 8, float(i) + 0.5, gid="bulk1")
                 for i in range(40)]
        reqs.sort(key=lambda r: r.submit_time)
        src = serving_trace_source(reqs, work_per_token=0.5, chunk_jobs=8)
        r = GridSim(NODES, config=SimConfig(retain_jobs=True)).run(src)
        assert r.stats.admitted == 80 and r.stats.finished == 80
        by_user = {j.user for j in r.jobs}
        assert by_user == {"tenantA", "tenantB"}
        a = next(j for j in r.jobs if j.user == "tenantA")
        assert a.work == (8 + 4) * 0.5
        assert a.input_bytes == 8 * 4                  # int32 prompt bytes
        b = next(j for j in r.jobs if j.user == "tenantB")
        assert b.group_id == "bulk1"

    def test_origin_of_routes_tenants(self):
        reqs = [_FakeRequest("a", 4, 2, 0.0), _FakeRequest("b", 4, 2, 0.0)]
        src = serving_trace_source(
            reqs, origin_of=lambda r: "site2" if r.user == "b" else "site1")
        jobs = [j for c in src.chunks() for j in c]
        assert {j.origin_site for j in jobs} == {"site1", "site2"}


# -- port ≡ reference ---------------------------------------------------------

def _reference_overload_jobs(seed=9):
    jobs = list(RS.bulk_burst("hog", 60, at=0.0, work=400.0,
                              data_site="site1", origin_site="site1"))
    jobs += list(RS.bulk_burst("polite", 20, at=5.0, work=100.0,
                               data_site="site2", origin_site="site2"))
    jobs += list(RS.poisson_stream("polite", 0.2, 400.0, seed=seed, work=120.0))
    return jobs


class TestPortEqualsReference:
    @pytest.mark.parametrize("horizon", [True, False])
    @pytest.mark.parametrize("policy", ["diana", "greedy", "local", "fcfs"])
    def test_runs_identical(self, policy, horizon):
        """The port's generators draw the reference's jobs, and its run
        loops place them exactly as the reference's do."""
        jobs = _overload_jobs()
        ref_jobs = _reference_overload_jobs()
        key = lambda js: [(j.user, j.arrival, j.work, j.data_site, j.origin_site) for j in js]  # noqa: E731
        assert key(jobs) == key(ref_jobs)
        cfg = dict(policy=policy, quotas=QUOTAS, migration_interval_s=30.0,
                   congestion_window_s=120.0, horizon=horizon)
        ref = RS.GridSim(NODES, config=RS.SimConfig(**cfg)).run(ref_jobs)
        assert_same_run(ref, GridSim(NODES, config=SimConfig(**cfg)).run(jobs))

    def test_streaming_source_identical(self):
        cfg = dict(policy="diana", quotas=QUOTAS, migration_interval_s=30.0,
                   congestion_window_s=120.0, retain_jobs=True)
        ref = RS.GridSim(NODES, config=RS.SimConfig(**cfg)).run(
            RS.poisson_source("u", 1.0, 300.0, seed=5, work=90.0, chunk_jobs=17))
        port = GridSim(NODES, config=SimConfig(**cfg)).run(
            poisson_source("u", 1.0, 300.0, seed=5, work=90.0, chunk_jobs=17))
        assert_same_run(ref, port)
        assert ref.queue_time_percentiles() == port.queue_time_percentiles()
        assert ref.turnaround_percentiles() == port.turnaround_percentiles()
