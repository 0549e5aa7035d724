"""Simulator configuration, fault scripts and the link-table lifecycle,
ported: the reference's tests/sim/test_config_shim.py (minus its
multi-scheduler lines), test_faults_validation.py and test_link_table.py
against ``repro_torch.sim`` on the host, and ``repro_torch.sim.interop``
carrying every input across from the reference."""
from __future__ import annotations

import copy
import functools
import math
import warnings

import numpy as np
import pytest

import repro.core as R
import repro.sim as RS
import repro_torch.core as P
import repro_torch.sim as PS
import repro_torch.sim.config as config_mod
from _torch_sim_twins import assert_same_run, run_both
from repro_torch.core.costs import NetworkLink
from repro_torch.sim import SimConfig, SimJob, interop, uniform_links
from repro_torch.sim.faults import (
    FaultEvent,
    FaultPlan,
    PartitionWindow,
    TransportFaults,
)

GridSim = functools.partial(PS.GridSim, device="cpu")
NODES = {"site1": 2, "site2": 2, "site3": 2}


# -- tests/sim/test_config_shim.py ----------------------------------------------


def test_unknown_kwarg_raises_typeerror():
    with pytest.raises(TypeError, match=r"GridSim\(\) got unexpected keyword "
                                        r"argument\(s\) \['bogus'\]"):
        GridSim(NODES, bogus=1)


def test_p2p_field_rejected_on_base_gridsim():
    """P2P-only knobs keyword-passed to plain GridSim fail exactly like
    the old explicit signature did."""
    with pytest.raises(TypeError, match="num_peers"):
        GridSim(NODES, num_peers=4)
    with pytest.raises(TypeError, match="gossip_wire"):
        GridSim(NODES, gossip_wire="full")
    # ...and harmless as unread fields of a config given to GridSim.
    sim = GridSim(NODES, config=SimConfig(num_peers=7))
    assert sim.config.num_peers == 7


def test_deprecation_warning_exactly_once_per_process():
    original = config_mod._warned_legacy
    try:
        config_mod._warned_legacy = False
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            GridSim(NODES, policy="greedy")
            GridSim(NODES, policy="diana")           # second legacy use
            GridSim(NODES, config=SimConfig())       # non-legacy use
        legacy = [w for w in caught if issubclass(w.category, DeprecationWarning)
                  and "deprecated" in str(w.message)]
        assert len(legacy) == 1
        assert "['policy']" in str(legacy[0].message)
    finally:
        config_mod._warned_legacy = original


def test_unknown_kwarg_beats_deprecation_warning():
    """A typo'd kwarg is a TypeError even before any legacy warning —
    and must not consume the once-per-process warning budget."""
    original = config_mod._warned_legacy
    try:
        config_mod._warned_legacy = False
        with pytest.raises(TypeError):
            GridSim(NODES, polciy="diana")
        assert config_mod._warned_legacy is False
    finally:
        config_mod._warned_legacy = original


def test_legacy_kwargs_override_config_fields():
    cfg = SimConfig(policy="greedy", migration_interval_s=120.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        sim = GridSim(NODES, config=cfg, migration_interval_s=30.0)
    assert sim.policy == "greedy"                    # from config
    assert sim.migration_interval_s == 30.0          # kwarg wins
    assert cfg.migration_interval_s == 120.0         # caller's config intact


# -- tests/sim/test_faults_validation.py ----------------------------------------

class TestFaultPlanCoherence:
    """Satellite: ``FaultPlan.check`` rejects incoherent histories with
    clear errors — one test per rejection."""

    def test_site_down_while_already_down(self):
        plan = FaultPlan().site_down(10.0, "a").site_down(20.0, "a")
        with pytest.raises(ValueError, match="already down"):
            plan.check()

    def test_site_up_never_taken_down(self):
        plan = FaultPlan().site_up(10.0, "a")
        with pytest.raises(ValueError, match="not down at that time"):
            plan.check()

    def test_site_up_before_its_down_is_out_of_order(self):
        # The timestamps are swapped: the up fires chronologically
        # before the down, so the replay sees an up for a live site.
        plan = FaultPlan().site_down(100.0, "a").site_up(50.0, "a")
        with pytest.raises(ValueError, match="out of order"):
            plan.check()

    def test_peer_leaves_twice(self):
        plan = FaultPlan().peer_leave(10.0, 1).peer_leave(20.0, 1)
        with pytest.raises(ValueError, match="already departed"):
            plan.check()

    def test_peer_join_without_leaving(self):
        plan = FaultPlan().peer_join(10.0, 1)
        with pytest.raises(ValueError, match="without having left"):
            plan.check()

    def test_peer_join_before_its_leave_is_out_of_order(self):
        plan = FaultPlan().peer_leave(100.0, 2).peer_join(50.0, 2)
        with pytest.raises(ValueError, match="out of order"):
            plan.check()

    def test_link_restore_without_degrade(self):
        plan = FaultPlan().link_restore(10.0, site="a")
        with pytest.raises(ValueError, match="no earlier link_degrade"):
            plan.check()

    def test_link_restore_wrong_target(self):
        plan = (
            FaultPlan()
            .link_degrade(5.0, site="a", bandwidth_factor=0.5)
            .link_restore(10.0, site="b")
        )
        with pytest.raises(ValueError, match="no earlier link_degrade"):
            plan.check()

    def test_out_of_chronology_insertion_still_coheres(self):
        # Builders may append events in any order; only the
        # time-sorted replay must make sense.
        plan = (
            FaultPlan()
            .site_up(100.0, "a")
            .site_down(50.0, "a")
            .peer_join(80.0, 0)
            .peer_leave(40.0, 0)
        )
        assert plan.check() is plan          # chains

    def test_down_up_down_alternation_ok(self):
        plan = (
            FaultPlan()
            .site_down(10.0, "a").site_up(20.0, "a")
            .site_down(30.0, "a").site_up(40.0, "a")
        )
        plan.check()

    def test_validate_runs_check_first(self):
        plan = FaultPlan().site_up(10.0, "a")
        with pytest.raises(ValueError, match="not down at that time"):
            plan.validate(sites={"a"})

    def test_non_finite_event_time_rejected(self):
        for bad in (math.nan, math.inf, -math.inf):
            with pytest.raises(ValueError, match="finite"):
                FaultEvent(kind="site_down", time=bad, site="a")


class TestPartitionWindow:
    def test_end_must_follow_start(self):
        for start, end in ((10.0, 10.0), (10.0, 5.0), (0.0, math.nan)):
            with pytest.raises(ValueError, match="end after it starts"):
                PartitionWindow(start=start, end=end,
                                groups=(frozenset("a"), frozenset("b")))

    def test_start_must_be_finite_nonnegative(self):
        for bad in (-1.0, math.nan, math.inf):
            with pytest.raises(ValueError, match="start"):
                PartitionWindow(start=bad, end=1e9,
                                groups=(frozenset("a"), frozenset("b")))

    def test_needs_two_groups(self):
        with pytest.raises(ValueError, match="at least two groups"):
            PartitionWindow(start=0.0, end=1.0, groups=(frozenset("a"),))

    def test_groups_must_be_non_empty(self):
        with pytest.raises(ValueError, match="non-empty"):
            PartitionWindow(start=0.0, end=1.0,
                            groups=(frozenset("a"), frozenset()))

    def test_groups_must_be_disjoint(self):
        with pytest.raises(ValueError, match="overlap"):
            PartitionWindow(
                start=0.0, end=1.0,
                groups=(frozenset(["a", "b"]), frozenset(["b", "c"])),
            )

    def test_blocks_is_start_inclusive_end_exclusive(self):
        w = PartitionWindow(start=10.0, end=20.0,
                            groups=(frozenset(["a"]), frozenset(["b"])))
        assert not w.blocks("a", "b", 9.999)
        assert w.blocks("a", "b", 10.0)
        assert w.blocks("b", "a", 19.999)
        assert not w.blocks("a", "b", 20.0)

    def test_same_group_and_unlisted_sites_flow(self):
        w = PartitionWindow(start=0.0, end=1e9,
                            groups=(frozenset(["a", "c"]), frozenset(["b"])))
        assert not w.blocks("a", "c", 5.0)    # same side of the cut
        assert not w.blocks("a", "x", 5.0)    # x in no group
        assert not w.blocks("x", "y", 5.0)


class TestTransportFaults:
    def test_probabilities_screened(self):
        for field in ("loss", "duplicate", "corrupt",
                      "burst_p", "burst_r", "burst_loss"):
            with pytest.raises(ValueError, match=field):
                TransportFaults(**{field: 1.5})
            with pytest.raises(ValueError, match=field):
                TransportFaults(**{field: -0.1})

    def test_knobs_screened(self):
        with pytest.raises(ValueError, match="reorder_jitter_s"):
            TransportFaults(reorder_jitter_s=-1.0)
        with pytest.raises(ValueError, match="rto_s"):
            TransportFaults(rto_s=0.0)
        with pytest.raises(ValueError, match="rto_backoff"):
            TransportFaults(rto_backoff=0.5)
        with pytest.raises(ValueError, match="rto_jitter"):
            TransportFaults(rto_jitter=-0.1)
        with pytest.raises(ValueError, match="max_retransmits"):
            TransportFaults(max_retransmits=-1)
        with pytest.raises(ValueError, match="phi_threshold"):
            TransportFaults(phi_threshold=0.0)
        with pytest.raises(ValueError, match="phi_window"):
            TransportFaults(phi_window=1)

    def test_bursts_must_be_able_to_end(self):
        with pytest.raises(ValueError, match="burst_r"):
            TransportFaults(burst_p=0.1, burst_r=0.0)

    def test_enabled_and_can_lose(self):
        assert not TransportFaults().enabled
        assert not TransportFaults().can_lose
        # Duplication and jitter delay but never lose: no RTO needed.
        dup = TransportFaults(duplicate=0.5, reorder_jitter_s=3.0)
        assert dup.enabled and not dup.can_lose
        for kw in (dict(loss=0.1), dict(corrupt=0.1), dict(burst_p=0.1)):
            t = TransportFaults(**kw)
            assert t.enabled and t.can_lose
        w = PartitionWindow(start=0.0, end=1.0,
                            groups=(frozenset("a"), frozenset("b")))
        t = TransportFaults(partitions=(w,))
        assert t.enabled and t.can_lose

    def test_partitioned_unions_windows(self):
        w1 = PartitionWindow(start=0.0, end=10.0,
                             groups=(frozenset(["a"]), frozenset(["b"])))
        w2 = PartitionWindow(start=20.0, end=30.0,
                             groups=(frozenset(["a"]), frozenset(["c"])))
        t = TransportFaults(partitions=(w1, w2))
        assert t.partitioned("a", "b", 5.0)
        assert not t.partitioned("a", "b", 15.0)
        assert t.partitioned("c", "a", 25.0)
        assert not t.partitioned("a", "b", 25.0)


# -- tests/sim/test_link_table.py ---------------------------------------------


class CountingLinks(dict):
    """Link table counting every item lookup."""

    lookups = 0

    def __getitem__(self, key):
        self.lookups += 1
        return super().__getitem__(key)


def _partial_links() -> CountingLinks:
    """Full mesh minus one pair no site1-anchored workload touches."""
    table = CountingLinks(uniform_links(list(NODES)))
    del table[("site2", "site3")]
    return table


def _workload(n=12):
    return [
        SimJob(user="u", arrival=float(i), work=30.0, input_bytes=1e8,
               data_site="site1", origin_site="site1")
        for i in range(n)
    ]


def test_partial_table_never_rescans_dense():
    links = _partial_links()
    sim = GridSim(NODES, links=links, config=SimConfig(policy="diana"))
    assert sim.batch_arrivals

    # First attempt: scans, fails on the missing pair, disables.
    assert sim._link_matrices_ready() is False
    assert sim._dense_failed
    assert not sim.batch_arrivals
    assert sim._batch_arrivals_auto_disabled
    assert links.lookups > 0

    # The pinned behaviour: a known-partial table is never rescanned —
    # the re-check is O(1) with ZERO link lookups, not a silent S² walk.
    links.lookups = 0
    for _ in range(3):
        assert sim._link_matrices_ready() is False
    assert links.lookups == 0

    # The sequential fallback still runs the workload end to end.
    res = sim.run(_workload())
    assert res.stats.finished == 12
    assert all(j.finish >= 0 for j in res.jobs)
    assert sim._dense_failed and not sim.batch_arrivals


def test_invalidate_links_rearms_densify_and_fast_path():
    links = _partial_links()
    sim = GridSim(NODES, links=links, config=SimConfig(policy="diana"))
    assert sim._link_matrices_ready() is False

    # Healing the table in place + invalidate_links: one new scan is
    # allowed, succeeds, and the auto-disabled fast path comes back.
    links[("site2", "site3")] = NetworkLink(bandwidth_Bps=1e9)
    sim.invalidate_links()
    assert not sim._dense_failed
    assert sim.batch_arrivals
    assert sim._link_matrices_ready() is True
    assert sim._loss is not None


def test_new_table_assignment_rearms_via_setter():
    sim = GridSim(NODES, links=_partial_links(),
                  config=SimConfig(policy="diana"))
    assert sim._link_matrices_ready() is False
    sim.links = uniform_links(list(NODES))      # setter invalidates
    assert sim._link_matrices_ready() is True
    assert sim.batch_arrivals


def test_users_own_batch_arrivals_setting_survives():
    """Auto re-enable must never override an explicit user opt-out."""
    sim = GridSim(NODES, links=_partial_links(),
                  config=SimConfig(policy="diana", batch_arrivals=False))
    assert sim._link_matrices_ready() is False
    assert not sim._batch_arrivals_auto_disabled    # was already off
    sim.links = uniform_links(list(NODES))
    assert sim._link_matrices_ready() is True
    assert not sim.batch_arrivals                   # user's choice stands


# -- interop: the reference's inputs, carried across ------------------------------

def _topology(mod, names, n_tiers):
    topo = mod.GridTopology()
    for i, n in enumerate(names):
        topo.join(f"root{i % n_tiers}", mod.Node(name=n, availability=0.5 + 0.01 * i))
    return topo


def test_config_from_reference_carries_every_field():
    names = [f"s{i}" for i in range(7)]
    plan = RS.FaultPlan().site_down(10.0, "s1").site_up(20.0, "s1").link_degrade(
        5.0, "s2", bandwidth_factor=0.5, loss_add=0.01)
    tf = RS.TransportFaults(seed=3, loss=0.1, partitions=(
        RS.PartitionWindow(1.0, 2.0, (frozenset({"s0"}), frozenset({"s1"}))),))
    cfg = RS.SimConfig(policy="greedy", quotas={"a": 2.0}, placement="hier",
                       topology=_topology(R, names, 3), fault_plan=plan, transport_faults=tf,
                       weights=R.CostWeights(w_queue=0.5, w_work=2.0, w_load=0.25),
                       horizon=False, num_peers=5)
    got = interop.config_from_reference(cfg)
    assert isinstance(got, PS.SimConfig)
    for f in ("policy", "quotas", "placement", "horizon", "num_peers", "bucket_s"):
        assert getattr(got, f) == getattr(cfg, f)
    assert vars(got.weights) == vars(cfg.weights)
    assert [vars(e) for e in got.fault_plan.events] == [vars(e) for e in cfg.fault_plan.events]
    assert got.transport_faults.partitions[0].groups == tf.partitions[0].groups
    assert got.topology.tier_members(names) == cfg.topology.tier_members(names)
    assert got.topology.site_tiers(names + ["x"]) == cfg.topology.site_tiers(names + ["x"])


def test_topology_from_reference_keeps_roles_and_uids():
    names = [f"n{i}" for i in range(9)]
    ref = _topology(R, names, 2)
    ref.fail_site_master("root0")
    got = interop.topology_from_reference(ref)
    for site, root in ref.rootgrids.items():
        mine = got.rootgrids[site]
        assert (mine.master.name, mine.master.uid, mine.standby and mine.standby.name) == \
            (root.master.name, root.master.uid, root.standby and root.standby.name)
        assert mine.node_table == root.node_table
    n_ref, n_port = R.Node(name="late"), P.Node(name="late")
    ref.join("root1", n_ref)
    got.join("root1", n_port)
    assert n_port.uid == n_ref.uid


def test_jobs_and_links_from_reference():
    jobs = RS.cms_case_study(scale=0.1, seed=3)
    got = interop.jobs_from_reference(jobs)
    assert isinstance(got, PS.JobList) and [vars(j) for j in got] == [vars(j) for j in jobs]
    links = RS.uniform_links(["a", "b"], bandwidth_Bps=3e8, loss_rate=0.01)
    mine = interop.links_from_reference(links)
    assert list(mine) == list(links)
    assert all(vars(mine[k]) == vars(v) for k, v in links.items())


def test_fault_plan_run_matches_reference():
    """Site faults and link degradation through the carried plan: the
    same requeues, redirects and placements."""
    rng = np.random.default_rng(11)
    names = [f"s{i:02d}" for i in range(10)]
    links = {(a, b): RS.uniform_links([a, b], bandwidth_Bps=float(rng.uniform(1e6, 1e8)),
                                      loss_rate=float(rng.uniform(0.0, 0.02)))[(a, b)]
             if a != b else RS.uniform_links([a])[(a, a)] for a in names for b in names}
    jobs = []
    for i in range(120):
        jobs += RS.bulk_burst(f"u{i % 3}", 1, at=float(i // 6) * 5.0,
                              work=float(rng.integers(10, 400)), input_bytes=float(rng.choice([0, 2e9])),
                              data_site=names[i % 10], origin_site=names[(i * 3) % 10])
    plan = RS.FaultPlan().site_down(15.0, names[2]).site_up(80.0, names[2]).link_degrade(
        20.0, names[4], bandwidth_factor=0.1, loss_add=0.02).link_restore(60.0, names[4])
    for policy in ("diana", "greedy", "local", "fcfs"):
        ref, port = run_both({n: 2 for n in names}, jobs, links=links, policy=policy,
                             fault_plan=copy.deepcopy(plan), quotas={"u0": 5.0, "u1": 50.0},
                             migration_interval_s=30.0, congestion_window_s=60.0)
        assert_same_run(ref, port)
        assert port.stats.requeued > 0 or policy == "fcfs"
