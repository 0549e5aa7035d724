"""SimConfig(placement="hier") end-to-end equivalence, ported.

The reference suite (tests/sim/test_hier_sim.py, minus its multi-
scheduler cases) on ``repro_torch.sim.GridSim`` (host): hier ≡ flat over
whole runs, both run loops, with topologies, dead sites and dense bursts
in play — and each of those runs ≡ the reference's, plus
benchmarks/hier_bench.py's simulator grid at a small size.
"""
import copy
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as R
import repro.sim as RS
import repro_torch.sim as PS
from _torch_sim_twins import assert_same_run, run_both
from repro_torch.core import GridTopology, NetworkLink, Node
from repro_torch.sim import SimConfig
from repro_torch.sim.faults import FaultPlan
from repro_torch.sim.workloads import SimJob

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
from hier_bench import _build_sim as bench_build_sim  # noqa: E402

GridSim = functools.partial(PS.GridSim, device="cpu")


def _grid(rng, n_sites):
    names = [f"s{i:02d}" for i in range(n_sites)]
    spec = {n: int(rng.integers(1, 5)) for n in names}
    links = {}
    for a in names:
        for b in names:
            links[(a, b)] = NetworkLink(
                bandwidth_Bps=float(rng.uniform(1e6, 1e8)),
                loss_rate=0.0 if a == b else float(rng.uniform(0.0, 0.02)),
                rtt_s=float(rng.uniform(0.01, 0.3)),
            )
    return names, spec, links


def _topology(names, n_tiers):
    topo = GridTopology()
    for i, n in enumerate(names):
        topo.join(f"root{i % n_tiers}", Node(name=n))
    return topo


def _workload(rng, names, n=300):
    S = len(names)
    return [
        SimJob(
            user=("hog" if i % 5 == 0 else f"u{i % 7}"),
            arrival=float(i // 8) * 5.0,
            work=float(rng.integers(10, 600)),
            input_bytes=float(rng.choice([0.0, 1e6, 5e9])),
            output_bytes=float(rng.choice([0.0, 2e8])),
            data_site=(names[i % S] if i % 3 else None),
            origin_site=names[(i * 7) % S],
        )
        for i in range(n)
    ]


def _trace(result):
    return [
        (j.user, j.arrival, j.exec_site, j.start, j.finish,
         j.migrated, j.requeues)
        for j in result.jobs
    ]


class TestHierSimEquivalence:
    def _run(self, cls, spec, links, jobs, placement, topo, horizon, **kw):
        cfg = SimConfig(
            policy="diana", placement=placement, topology=topo,
            migration_interval_s=30.0, congestion_window_s=120.0,
            horizon=horizon, **kw,
        )
        sim = cls(dict(spec), links=dict(links), config=cfg)
        return sim.run(copy.deepcopy(jobs))

    @pytest.mark.parametrize("horizon", [True, False])
    def test_gridsim_hier_matches_flat(self, horizon):
        rng = np.random.default_rng(7)
        names, spec, links = _grid(rng, 24)
        topo = _topology(names, 4)
        jobs = _workload(rng, names)
        rf = self._run(GridSim, spec, links, jobs, "flat", topo, horizon)
        rh = self._run(GridSim, spec, links, jobs, "hier", topo, horizon)
        assert _trace(rf) == _trace(rh)
        assert rf.migrations() == rh.migrations()
        assert rh.migrations() > 0           # the §IX path actually ran

    def test_hier_with_site_faults_matches_flat(self):
        """Dead columns change which tiers can win — the poisoning must
        flow through the bounds exactly like the flat inf-mask."""
        rng = np.random.default_rng(11)
        names, spec, links = _grid(rng, 16)
        topo = _topology(names, 3)
        jobs = _workload(rng, names, n=250)
        plan = FaultPlan()
        plan.site_down(20.0, names[3]); plan.site_up(120.0, names[3])
        plan.site_down(50.0, names[7]); plan.site_up(300.0, names[7])
        rf = self._run(GridSim, spec, links, jobs, "flat", topo, True,
                       fault_plan=copy.deepcopy(plan))
        rh = self._run(GridSim, spec, links, jobs, "hier", topo, True,
                       fault_plan=copy.deepcopy(plan))
        assert _trace(rf) == _trace(rh)

    def test_hier_without_topology_is_single_tier(self):
        """No topology ⇒ one tier over the whole grid; still identical."""
        rng = np.random.default_rng(13)
        names, spec, links = _grid(rng, 12)
        jobs = _workload(rng, names, n=150)
        rf = self._run(GridSim, spec, links, jobs, "flat", None, True)
        rh = self._run(GridSim, spec, links, jobs, "hier", None, True)
        assert _trace(rf) == _trace(rh)

    def test_invalid_placement_rejected(self):
        rng = np.random.default_rng(0)
        _, spec, links = _grid(rng, 4)
        with pytest.raises(ValueError):
            GridSim(spec, links=links, config=SimConfig(placement="tiered"))

    def test_invalidate_links_rebuilds_hier_aggregates(self):
        """Swapping the link table must drop the tier aggregates with
        the dense matrices — stale bounds would silently misprune."""
        rng = np.random.default_rng(17)
        names, spec, links = _grid(rng, 12)
        topo = _topology(names, 3)
        jobs = _workload(rng, names, n=120)
        cfg = SimConfig(policy="diana", placement="hier", topology=topo)
        sim = GridSim(dict(spec), links=dict(links), config=cfg)
        assert sim._hier_ready() and sim._h_perm is not None
        _, spec2, links2 = _grid(rng, 12)
        sim.links = links2                       # setter → invalidate_links
        assert sim._h_perm is None
        # and a fresh flat sim over the new table still agrees
        rh = sim.run(copy.deepcopy(jobs))
        flat = GridSim(dict(spec), links=dict(links2),
                       config=SimConfig(policy="diana", placement="flat",
                                        topology=topo))
        rf = flat.run(copy.deepcopy(jobs))
        assert _trace(rh) == _trace(rf)


def _ref_grid(rng, n_sites):
    """_grid over the reference's NetworkLink (the same draws)."""
    names = [f"s{i:02d}" for i in range(n_sites)]
    spec = {n: int(rng.integers(1, 5)) for n in names}
    links = {}
    for a in names:
        for b in names:
            links[(a, b)] = R.NetworkLink(
                bandwidth_Bps=float(rng.uniform(1e6, 1e8)),
                loss_rate=0.0 if a == b else float(rng.uniform(0.0, 0.02)),
                rtt_s=float(rng.uniform(0.01, 0.3)),
            )
    return names, spec, links


def _ref_workload(rng, names, n=300):
    S = len(names)
    return [
        RS.SimJob(user=("hog" if i % 5 == 0 else f"u{i % 7}"), arrival=float(i // 8) * 5.0,
                  work=float(rng.integers(10, 600)),
                  input_bytes=float(rng.choice([0.0, 1e6, 5e9])),
                  output_bytes=float(rng.choice([0.0, 2e8])),
                  data_site=(names[i % S] if i % 3 else None), origin_site=names[(i * 7) % S])
        for i in range(n)
    ]


def _ref_topology(names, n_tiers):
    topo = R.GridTopology()
    for i, n in enumerate(names):
        topo.join(f"root{i % n_tiers}", R.Node(name=n))
    return topo


class TestPortEqualsReference:
    MIG = dict(policy="diana", migration_interval_s=30.0, congestion_window_s=120.0)

    @pytest.mark.parametrize("horizon", [True, False])
    @pytest.mark.parametrize("placement", ["flat", "hier"])
    def test_gridsim_runs(self, placement, horizon):
        rng = np.random.default_rng(7)
        names, spec, links = _ref_grid(rng, 24)
        topo = _ref_topology(names, 4)
        ref, port = run_both(spec, _ref_workload(rng, names), links=links, placement=placement,
                             topology=topo, horizon=horizon, **self.MIG)
        assert_same_run(ref, port)
        assert port.migrations() > 0

    @pytest.mark.parametrize("placement", ["flat", "hier"])
    def test_site_faults(self, placement):
        rng = np.random.default_rng(11)
        names, spec, links = _ref_grid(rng, 16)
        jobs = _ref_workload(rng, names, n=250)
        plan = RS.FaultPlan()
        plan.site_down(20.0, names[3]); plan.site_up(120.0, names[3])
        plan.site_down(50.0, names[7]); plan.site_up(300.0, names[7])
        ref, port = run_both(spec, jobs, links=links, placement=placement,
                             topology=_ref_topology(names, 3), fault_plan=plan, **self.MIG)
        assert_same_run(ref, port)

    @pytest.mark.parametrize("placement", ["flat", "hier"])
    def test_hier_bench_grid(self, placement):
        """benchmarks/hier_bench.py:_build_sim at its smoke size (32
        sites, 4 tiers, 800 jobs); the smoke runs 256/16 and 1000/50."""
        spec, links, topo, jobs = bench_build_sim(32, 4, 0)
        ref, port = run_both(spec, jobs, links=links, placement=placement, topology=topo,
                             **self.MIG)
        assert_same_run(ref, port)
