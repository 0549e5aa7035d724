"""The port's multi-scheduler simulator (``repro_torch.sim.P2PGridSim``)
against ``repro.sim.P2PGridSim``, on the host: whole traces, timelines,
stream statistics and exchange statistics of one workload through both
packages, on both wires, with and without a topology, under peer churn,
transport faults and ``placement="hier"``; then
tests/sim/test_transport_sim.py and test_grid_sim.py::TestP2PGridSim on
the port."""
import copy
import functools
import math
import warnings

import numpy as np
import pytest
import torch

import repro.core as R
import repro.sim as RS
import repro_torch.core as P
import repro_torch.sim as PS
from _torch_sim_twins import CPU, QUOTAS, assert_same_run, trace
from repro_torch.sim import bench_inputs, interop

#: The port's simulators on the host (the tests' device).
GridSim = functools.partial(PS.GridSim, device=CPU)
P2PGridSim = functools.partial(PS.P2PGridSim, device=CPU)

NODES = RS.paper_grid_spec()
MIGRATING = dict(quotas=QUOTAS, migration_interval_s=30.0, congestion_window_s=120.0)


def _p2p_workload(n=80, seed=0):
    """TestP2PGridSim's workload: compute bursts from random origins."""
    rng = np.random.default_rng(seed)
    names = sorted(NODES)
    jobs = []
    for i in range(n):
        jobs.extend(RS.bulk_burst(
            f"u{i % 4}", 2, at=float(i * 4), work=float(rng.uniform(30, 120)),
            input_bytes=0.0, output_bytes=0.0, data_site=None,
            origin_site=names[int(rng.integers(len(names)))], rng=rng, work_jitter=0.2))
    return sorted(jobs, key=lambda j: j.arrival)


def _small_overload():
    """The overload workload cut to 3 bursts of 20 hogs: 46 migrations
    over a few hundred exchange rounds."""
    return bench_inputs.overload_workload(3, 20, sim_mod=RS)


def _transport_jobs(seed=9):
    """tests/sim/test_transport_sim.py's workload."""
    jobs = list(RS.bulk_burst("hog", 50, at=0.0, work=400.0, data_site="site1",
                              origin_site="site1"))
    jobs += list(RS.poisson_stream("polite", 0.2, 400.0, seed=seed, work=120.0))
    return jobs


def run_p2p_both(nodes, jobs, links=None, **cfg):
    """One workload through both P2P simulators: ((reference sim,
    result), (port sim, result)), inputs carried across by interop."""
    config = RS.SimConfig(**cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rs = RS.P2PGridSim(dict(nodes), links=None if links is None else dict(links),
                           config=copy.deepcopy(config))
        ref = rs.run(copy.deepcopy(jobs))
        ps = P2PGridSim(dict(nodes),
                        links=None if links is None else interop.links_from_reference(links),
                        config=interop.config_from_reference(config))
        port = ps.run(interop.jobs_from_reference(jobs))
    return (rs, ref), (ps, port)


def assert_same_p2p(both):
    (rs, ref), (ps, port) = both
    assert_same_run(ref, port)
    assert ps.exchange.stats.as_dict() == rs.exchange.stats.as_dict()
    for a, b in zip(rs.peers, ps.peers):
        assert np.asarray(b.version).tolist() == a.version.tolist()
        assert np.asarray(b.stamp).tolist() == a.stamp.tolist()
        assert np.asarray(b.view.queue).tolist() == a.view.queue.tolist()
        assert sorted(b.home_names) == sorted(a.home_names)
    assert ps.migration_max_staleness_s == rs.migration_max_staleness_s


def _tiers(names, n_tiers, mod):
    topo = mod.GridTopology()
    for i, n in enumerate(sorted(names)):
        topo.join(f"root{i % n_tiers}", mod.Node(name=n))
    return topo


class TestTracesMatchReference:
    """Whole P2PGridSim runs of one workload through both packages."""

    @pytest.mark.parametrize("wire", ["delta", "full"])
    @pytest.mark.parametrize("horizon", [False, True])
    def test_wires_and_loops(self, wire, horizon):
        both = run_p2p_both(NODES, _small_overload(), num_peers=3, exchange_interval_s=45.0,
                            exchange_latency_s=5.0, gossip_wire=wire, horizon=horizon, **MIGRATING)
        assert_same_p2p(both)
        assert both[1][1].migrations() > 0

    @pytest.mark.parametrize("quant,fanout,full_sync_every,interval", [
        ("f16", 2, 4, 10.0), ("f32", 1, 32, 30.0)])
    def test_gossip_heavy(self, quant, fanout, full_sync_every, interval):
        assert_same_p2p(run_p2p_both(
            NODES, _small_overload(), num_peers=5, exchange_interval_s=interval,
            exchange_latency_s=2.0, gossip_fanout=fanout, gossip_quant=quant,
            gossip_full_sync_every=full_sync_every, quotas=QUOTAS, migration_interval_s=20.0,
            congestion_window_s=60.0))

    @pytest.mark.parametrize("wire", ["delta", "full"])
    def test_topology_and_summaries(self, wire):
        nodes = bench_inputs.p2p_grid(12)
        jobs = bench_inputs.p2p_workload(sorted(nodes), 240, sim_mod=RS)
        assert_same_p2p(run_p2p_both(
            nodes, jobs, num_peers=6, exchange_interval_s=20.0, exchange_latency_s=1.0,
            topology=_tiers(nodes, 3, R), gossip_summaries=True, gossip_wire=wire))

    @pytest.mark.parametrize("batched", [False, True])
    def test_staleness_gated_migration(self, batched):
        """Both §IX passes with the P2P staleness gating active (the
        sequential one reads the staleness column back once)."""
        both = run_p2p_both(NODES, _small_overload(), num_peers=5, exchange_interval_s=60.0,
                            exchange_latency_s=5.0, batch_migration=batched, **MIGRATING)
        assert_same_p2p(both)
        assert both[1][1].migrations() > 0

    def test_peer_churn(self):
        plan = RS.FaultPlan().peer_leave(150.0, 1).peer_join(420.0, 1).site_down(
            200.0, "site3").site_up(500.0, "site3")
        both = run_p2p_both(NODES, _transport_jobs(), num_peers=4, exchange_interval_s=45.0,
                            exchange_latency_s=5.0, fault_plan=plan, **MIGRATING)
        assert_same_p2p(both)
        assert both[1][1].stats.requeued > 0

    @pytest.mark.parametrize("wire", ["delta", "full"])
    def test_lossy_transport(self, wire):
        tf = RS.TransportFaults(seed=3, loss=0.15, duplicate=0.05, reorder_jitter_s=8.0,
                                corrupt=0.02, burst_p=0.05, burst_r=0.4, burst_loss=0.8)
        both = run_p2p_both(NODES, _transport_jobs(), num_peers=3, exchange_interval_s=45.0,
                            exchange_latency_s=5.0, gossip_wire=wire, transport_faults=tf,
                            **MIGRATING)
        assert_same_p2p(both)
        assert both[1][0].exchange.stats.dropped > 0

    def test_partition_suspicion(self):
        north = frozenset(n for i, n in enumerate(sorted(NODES)) if i % 2 == 0)
        tf = RS.TransportFaults(seed=1, phi_threshold=3.0, partitions=(RS.PartitionWindow(
            start=100.0, end=700.0, groups=(north, frozenset(NODES) - north)),))
        both = run_p2p_both(NODES, _transport_jobs(), num_peers=3, exchange_interval_s=45.0,
                            exchange_latency_s=5.0, transport_faults=tf, **MIGRATING)
        assert_same_p2p(both)
        assert both[1][0].exchange.stats.sync_escalations > 0

    @pytest.mark.parametrize("horizon", [False, True])
    def test_hier_placement(self, horizon):
        spec, links, topo, jobs = bench_inputs.hier_sim_grid(20, 4, 9, sim_mod=RS, core_mod=R)
        kw = dict(num_peers=5, exchange_interval_s=60.0, topology=topo, horizon=horizon,
                  migration_interval_s=30.0, congestion_window_s=120.0)
        flat = run_p2p_both(spec, jobs[:240], links, placement="flat", **kw)
        hier = run_p2p_both(spec, jobs[:240], links, placement="hier", **kw)
        assert_same_p2p(hier)
        assert trace(hier[1][1]) == trace(flat[1][1])
        assert hier[1][1].migrations() > 0

    def test_snapshot_apis(self):
        (rs, _), (ps, _) = run_p2p_both(NODES, _p2p_workload(20), num_peers=3,
                                        exchange_interval_s=60.0)
        jobs = _p2p_workload(30, seed=4)
        pj = interop.jobs_from_reference(jobs)
        assert ps.choose_sites_batch(pj) == rs.choose_sites_batch(jobs)
        assert [ps.choose_site(sj) for sj in pj] == [rs.choose_site(sj) for sj in jobs]


class TestTransportSim:
    """tests/sim/test_transport_sim.py on the port."""

    LOSSY = PS.TransportFaults(seed=3, loss=0.15, duplicate=0.05,
                               reorder_jitter_s=8.0, corrupt=0.02)

    def _run(self, transport, wire="delta", horizon=False, **kw):
        cfg = PS.SimConfig(policy="diana", num_peers=3, exchange_interval_s=45.0,
                           exchange_latency_s=5.0, gossip_wire=wire,
                           transport_faults=transport, horizon=horizon, **MIGRATING, **kw)
        sim = P2PGridSim(NODES, config=cfg)
        return sim, sim.run(interop.jobs_from_reference(_transport_jobs()))

    @pytest.mark.parametrize("wire", ["delta", "full"])
    def test_zero_rate_transport_is_bit_identical(self, wire):
        _, base = self._run(None, wire=wire)
        sim, faulted = self._run(PS.TransportFaults(seed=42), wire=wire)
        assert trace(base) == trace(faulted)
        assert base.timeline == faulted.timeline
        assert sim.exchange.stats.dropped == 0 and sim.exchange.stats.retransmits == 0

    def test_lossy_horizon_equals_per_event(self):
        sa, ra = self._run(self.LOSSY, horizon=False)
        sb, rb = self._run(self.LOSSY, horizon=True)
        assert trace(ra) == trace(rb)
        assert sa.exchange.stats.as_dict() == sb.exchange.stats.as_dict()
        assert sa.exchange.stats.dropped > 0

    def test_rerun_on_same_sim_resets_transport(self):
        def twice():
            sim, _ = self._run(self.LOSSY)
            assert sim.exchange.in_flight == 0 and not sim.exchange._pending
            return sim, sim.run(interop.jobs_from_reference(_transport_jobs()))
        sa, ra = twice()
        sb, rb = twice()
        assert trace(ra) == trace(rb)
        assert sa.exchange.stats.as_dict() == sb.exchange.stats.as_dict()

    def test_staleness_widening_property(self):
        sim, _ = self._run(None)
        base = sim.migration_max_staleness_s
        sim._staleness_widen = 3.0
        assert sim.migration_max_staleness_s == 3.0 * base
        sim._staleness_widen = 1.0
        assert sim.migration_max_staleness_s == base
        sim.migration_max_staleness_s = 123.0
        assert sim.migration_max_staleness_s == 123.0

    def test_transport_faults_rejected_without_peers(self):
        with pytest.raises(TypeError):
            GridSim(NODES, transport_faults=self.LOSSY)

    def test_suspect_columns_are_masked_on_the_device(self):
        sim, _ = self._run(None)
        peer = sim.peers[0]
        sj = interop.jobs_from_reference(_p2p_workload(1))[0]
        sj.origin_site = peer.home
        base = sim._comp_vec(sj)
        mask = torch.zeros(len(sim._names_sorted), dtype=torch.bool)
        mask[1:] = True
        sim._suspect_masks = {0: mask}
        got = sim._comp_vec(sj)
        assert got[1:].isinf().all() and got[0] == base[0]
        stale = sim._migration_staleness(peer.home, 1.0)
        assert stale[1:].isinf().all() and isinstance(stale, torch.Tensor)
        sim._suspect_masks = {0: torch.ones_like(mask)}
        assert torch.equal(sim._comp_vec(sj), base)       # nowhere finite: unmasked


class TestP2PGridSim:
    """tests/sim/test_grid_sim.py::TestP2PGridSim on the port."""

    def _jobs(self, n=80, seed=0):
        return interop.jobs_from_reference(_p2p_workload(n, seed))

    @pytest.mark.parametrize("interval", [30.0, 600.0])
    @pytest.mark.parametrize("wire", ["delta", "full"])
    def test_single_peer_is_bit_identical_to_omniscient(self, interval, wire):
        jobs = self._jobs()
        base = GridSim(NODES, policy="diana").run(copy.deepcopy(jobs))
        one = P2PGridSim(NODES, num_peers=1, exchange_interval_s=interval,
                         gossip_wire=wire).run(copy.deepcopy(jobs))
        assert trace(base) == trace(one)
        assert base.timeline == one.timeline

    def test_multi_peer_completes_and_is_deterministic(self):
        runs = []
        for _ in range(2):
            sim = P2PGridSim(NODES, num_peers=3, exchange_interval_s=60.0,
                             exchange_latency_s=5.0)
            runs.append(sim.run(self._jobs()))
            assert all(j.finish >= 0 for j in runs[-1].jobs)
            assert sim.exchange.stats.rounds > 0 and sim.exchange.stats.adverts_sent > 0
        assert trace(runs[0]) == trace(runs[1])

    def test_peers_partition_all_sites(self):
        sim = P2PGridSim(NODES, num_peers=3)
        owned = [n for p in sim.peers for n in p.home_names]
        assert sorted(owned) == sorted(NODES) and len(sim.peers) == 3
        assert all(p.device == torch.device(CPU) for p in sim.peers)
        assert sim.exchange.device == torch.device(CPU)

    def test_migration_respects_staleness_trust(self):
        jobs = interop.jobs_from_reference(_small_overload())
        trusting = P2PGridSim(NODES, num_peers=5, exchange_interval_s=30.0, **MIGRATING)
        paranoid = P2PGridSim(NODES, num_peers=5, exchange_interval_s=30.0,
                              migration_max_staleness_s=-1.0, **MIGRATING)
        assert trusting.run(copy.deepcopy(jobs)).migrations() > 0
        res = paranoid.run(copy.deepcopy(jobs))
        assert res.migrations() == 0 and all(j.finish >= 0 for j in res.jobs)

    def test_config_validation(self):
        with pytest.raises(ValueError):
            P2PGridSim(NODES, policy="greedy")
        with pytest.raises(ValueError):
            P2PGridSim(NODES, config=PS.SimConfig(exchange_interval_s=0.0))

    def test_default_trust_horizons(self):
        topo = _tiers(NODES, 2, P)
        assert P2PGridSim(NODES, num_peers=5, topology=topo,
                          exchange_interval_s=30.0).migration_max_staleness_s == 4 * 30.0
        assert P2PGridSim(NODES, num_peers=5, gossip_fanout=1,
                          exchange_interval_s=60.0).migration_max_staleness_s == 5 * 60.0

    def test_late_start_trace_does_not_distrust_bootstrap(self):
        t0 = 86_400.0
        jobs = [PS.SimJob(user=("hog" if i >= 8 else "polite"), arrival=t0 + i, work=300.0,
                          input_bytes=2e9, data_site="site1", origin_site="site1")
                for i in range(80)]
        sim = P2PGridSim(NODES, num_peers=5, exchange_interval_s=600.0, **MIGRATING)
        res = sim.run(copy.deepcopy(jobs))
        assert all(j.finish >= 0 for j in res.jobs)
        assert res.migrations() > 0
        assert bool((sim.peers[0].stamp >= t0).all())

    def test_peer_links_are_home_relative(self):
        sim = P2PGridSim(NODES, num_peers=2)
        p = sim.peers[0]
        for n in sim._names_sorted:
            assert p.links[n] is sim.links[(p.home, n)]

    def test_all_sent_adverts_are_delivered(self):
        sim = P2PGridSim(NODES, num_peers=3, exchange_interval_s=30.0, exchange_latency_s=100.0)
        res = sim.run(self._jobs(40))
        assert all(j.finish >= 0 for j in res.jobs)
        assert sim.exchange.in_flight == 0 and sim.exchange.stats.deliveries > 0

    def test_exchange_cost_scales_down_with_interval(self):
        sent = []
        for iv in (30.0, 240.0):
            sim = P2PGridSim(NODES, num_peers=3, exchange_interval_s=iv)
            sim.run(self._jobs())
            sent.append(sim.exchange.stats.adverts_sent)
        assert sent[1] < sent[0]

    def test_summaries_flow_and_account(self):
        nodes = bench_inputs.p2p_grid(12)
        cfg = PS.SimConfig(policy="diana", topology=_tiers(nodes, 3, P), num_peers=6,
                           exchange_interval_s=20.0, gossip_summaries=True)
        sim = P2PGridSim(nodes, config=cfg)
        res = sim.run(bench_inputs.p2p_workload(sorted(nodes), 120))
        assert sim.exchange.stats.summaries_sent > 0
        assert max(len(p.tier_summaries) for p in sim.peers) >= 2
        assert res.finished == 120
        assert all(math.isfinite(s.comp_min) for p in sim.peers for s in p.tier_summaries.values())


def test_config_carries_the_p2p_fields_across():
    """A reference P2PGridSim configuration carries across: topology,
    transport faults (with partition windows) and every gossip field."""
    tf = RS.TransportFaults(seed=5, loss=0.1, partitions=(RS.PartitionWindow(
        start=1.0, end=2.0, groups=(frozenset({"site1"}), frozenset({"site2"}))),))
    cfg = RS.SimConfig(num_peers=4, exchange_interval_s=12.0, exchange_latency_s=3.0,
                       migration_max_staleness_s=99.0, gossip_fanout=2, gossip_wire="full",
                       gossip_quant="f16", gossip_full_sync_every=7, gossip_summaries=True,
                       topology=_tiers(NODES, 2, R), transport_faults=tf)
    got = interop.config_from_reference(cfg)
    for f in ("num_peers", "exchange_interval_s", "exchange_latency_s",
              "migration_max_staleness_s", "gossip_fanout", "gossip_wire", "gossip_quant",
              "gossip_full_sync_every", "gossip_summaries"):
        assert getattr(got, f) == getattr(cfg, f), f
    assert isinstance(got.transport_faults, PS.TransportFaults)
    assert repr(got.transport_faults) == repr(tf)
    assert got.topology.site_tiers(sorted(NODES)) == cfg.topology.site_tiers(sorted(NODES))
    sim = P2PGridSim(NODES, config=got)
    assert sim.exchange.wire == "full" and sim.exchange.quant == "f16"
    assert sim.exchange.transport is got.transport_faults
