"""§IX/§X migration inside the ported simulator: the batched pass ≡ the
per-job loop (tests/sim/test_grid_sim.py TestBatchedMigration) on the
port, and every variant ≡ the reference — whole runs, and one tick of
benchmarks/migration_bench.py's congested grid compared move for move."""
import copy

import pytest
import torch

import repro.core as R
import repro.sim as RS
import repro_torch.core as P
import repro_torch.sim as PS
from _torch_sim_twins import (
    MIGRATING,
    GridSim,
    assert_same_run,
    congested_sim,
    migration_snapshot,
    overload_workload,
    run_both,
    seeded_workload,
    trace,
)


class TestBatchedMigration:
    def _compare(self, jobs, nodes=None, links=None, **kw):
        nodes = nodes or RS.paper_grid_spec()
        cfg = dict(MIGRATING, **kw)
        runs = []
        for batched in (False, True):
            ref, port = run_both(nodes, jobs, links=links, policy="diana",
                                 batch_migration=batched, **cfg)
            assert_same_run(ref, port)
            runs.append(port)
        seq, bat = runs
        assert trace(seq) == trace(bat)
        assert seq.timeline == bat.timeline
        return seq, bat

    def test_overload_equivalence(self):
        _, bat = self._compare(overload_workload())
        assert bat.migrations() > 0

    def test_big_site_tiebreak_equivalence(self):
        """'big' sorts first but iterates last: peer tie-breaking must
        follow sites-dict order, not sorted-column order."""
        _, bat = self._compare(overload_workload(), nodes=dict(RS.paper_grid_spec(), big=50))
        assert bat.migrations() > 0

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_seeded_random_workloads(self, seed):
        _, bat = self._compare(seeded_workload(seed))
        assert all(j.finish >= 0 for j in bat.jobs)

    @pytest.mark.parametrize("placement", ["flat", "hier"])
    def test_hier_lazy_pass_equivalence(self, placement):
        _, bat = self._compare(seeded_workload(4), placement=placement)
        assert bat.migrations() > 0

    def test_off_grid_endpoints_fall_back_per_site(self):
        names = ["site1", "site2", "site3"]
        jobs = []
        for b in range(6):
            jobs.extend(RS.bulk_burst("hog", 12, at=float(b * 30), work=300.0, input_bytes=2e9,
                                      data_site="storage", origin_site="site1"))
        for i in range(10):
            jobs.extend(RS.bulk_burst("polite", 1, at=float(i * 20), work=300.0, input_bytes=2e9,
                                      data_site="storage", origin_site="site1"))
        self._compare(sorted(jobs, key=lambda j: j.arrival), nodes={n: 2 for n in names},
                      links=RS.uniform_links(names + ["storage"]))

    def test_batched_is_default(self):
        assert GridSim(PS.paper_grid_spec(), config=PS.SimConfig()).batch_migration


class TestCongestedTick:
    """One _on_migrate_check tick of the migration bench's congested grid
    (benchmarks/migration_bench.py, cut to 1,000 jobs × 64 sites here;
    the smoke runs 10,000 × 256 on the card)."""

    @pytest.mark.parametrize("seed", [0, 1])
    def test_tick_matches_reference(self, seed):
        ref, now = congested_sim(RS, R, 1000, 64, seed)
        seq = copy.deepcopy(ref)
        seq.batch_migration = False
        ref._on_migrate_check(now + 60.0, [])
        seq._on_migrate_check(now + 60.0, [])
        expect = migration_snapshot(ref)
        assert migration_snapshot(seq) == expect
        assert sum(m for _, m in expect["moves"]) > 100
        for placement in ("flat", "hier"):
            port, now = congested_sim(PS, P, 1000, 64, seed, placement=placement)
            port._on_migrate_check(now + 60.0, [])
            assert migration_snapshot(port) == expect, placement

    def test_deep_copied_twins_agree(self):
        base, now = congested_sim(PS, P, 400, 16, 3)
        a, b = copy.deepcopy(base), copy.deepcopy(base)
        b.batch_migration = False
        a._on_migrate_check(now + 60.0, [])
        b._on_migrate_check(now + 60.0, [])
        assert migration_snapshot(a) == migration_snapshot(b)

    def test_jobs_ahead_plane_is_mlfq_jobs_ahead(self):
        sim, now = congested_sim(PS, P, 600, 12, 5)
        names = list(sim.sites)
        probe = [-1.0, -0.5, -0.25, 0.0, 0.3, 1.0]
        probe += [j.priority for j in sim.sites[names[0]].mlfq.jobs][:10]
        plane = sim._jobs_ahead_plane(names, torch.tensor(probe, dtype=torch.float64))
        expect = [[sim.sites[n].mlfq.jobs_ahead(p) for n in names] for p in probe]
        assert plane.tolist() == expect
