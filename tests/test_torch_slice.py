"""The ported slice as a whole: the reference's state is carried across
with ``state_from_reference`` and the port, on the host, must decide
exactly what the reference decides — site choices, costs and final site
state of ``select_sites_batch``/``rank_sites_batch``/``place_batch``,
``schedule_groups`` placements, and the paper's Fig 4 split."""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
from bulk_placement_bench import _build as bench_build  # noqa: E402

CPU = "cpu"
FIG4_CAPS = {"A": 100.0, "B": 200.0, "C": 400.0, "D": 600.0}


def _grid(rng, n_sites, dead_fraction=0.25, lossless_fraction=0.3):
    """tests/core/test_batch.py's random grid, in reference objects."""
    sites, links = {}, {}
    for i in range(n_sites):
        name = f"s{i}"
        sites[name] = R.SiteState(
            name=name, capacity=float(rng.integers(10, 2000)),
            queue_length=float(rng.integers(0, 100)),
            waiting_work=float(rng.uniform(0, 1000)),
            load=float(rng.uniform(0, 1)),
            alive=bool(rng.uniform() > dead_fraction),
        )
        links[name] = R.NetworkLink(
            bandwidth_Bps=float(rng.uniform(1e8, 1e10)),
            loss_rate=0.0 if rng.uniform() < lossless_fraction else float(rng.uniform(1e-4, 0.05)),
            rtt_s=float(rng.uniform(0.001, 0.3)),
            mss_bytes=float(rng.choice([536.0, 1460.0, 9000.0])),
        )
    if not any(s.alive for s in sites.values()):
        next(iter(sites.values())).alive = True
    return sites, links


def _jobs(rng, n):
    return [
        R.Job(user=f"u{i % 3}", compute_work=float(rng.uniform(0.1, 200)),
              input_bytes=float(rng.uniform(0, 50e9)), output_bytes=float(rng.uniform(0, 1e9)))
        for i in range(n)
    ]


def _twins(sites, links, jobs, weights=None):
    """A reference scheduler and the port's (on the host) over copies of
    one state, plus each side's copy of the jobs."""
    st = P.state_from_reference(sites, links, jobs, weights)
    ref = R.DianaScheduler(copy.deepcopy(sites), dict(links), weights or R.CostWeights())
    port = P.DianaScheduler(copy.deepcopy(st.sites), dict(st.links), st.weights, device=CPU)
    return ref, port, copy.deepcopy(jobs), copy.deepcopy(st.jobs)


def _assert_same_state(ref, port):
    for name, s in ref.sites.items():
        assert (port.sites[name].queue_length, port.sites[name].waiting_work) == (
            s.queue_length, s.waiting_work)


def _assert_same_placement(got, expect):
    assert got.sites == expect.sites
    assert got.site_indices.tolist() == list(expect.site_indices)
    assert got.costs.tolist() == list(expect.costs)
    assert [c.value for c in got.classes] == [c.value for c in expect.classes]


class TestBenchConfiguration:
    """10,000 jobs × 256 sites, seed 0: benchmarks/bulk_placement_bench.py."""

    @pytest.fixture(scope="class")
    def bench(self):
        return bench_build(10_000, 256, 0)

    def test_select_sites_batch(self, bench):
        ref, port, jr, jp = _twins(*bench)
        _assert_same_placement(port.select_sites_batch(jp), ref.select_sites_batch(jr))

    def test_rank_sites_batch(self, bench):
        ref, port, jr, jp = _twins(*bench)
        assert port.rank_sites_batch(jp) == ref.rank_sites_batch(jr)

    def test_place_batch(self, bench):
        ref, port, jr, jp = _twins(*bench)
        _assert_same_placement(port.place_batch(jp), ref.place_batch(jr))
        _assert_same_state(ref, port)
        assert [j.site for j in jp] == [j.site for j in jr]


class TestRandomGrids:
    """tests/core/test_batch.py's grids: dead sites, lossless links,
    per-link mss, all three classes."""

    @pytest.mark.parametrize("seed", range(8))
    def test_place_batch(self, seed):
        rng = np.random.default_rng(seed)
        sites, links = _grid(rng, int(rng.integers(2, 24)))
        ref, port, jr, jp = _twins(sites, links, _jobs(rng, int(rng.integers(1, 50))))
        _assert_same_placement(port.place_batch(jp), ref.place_batch(jr))
        _assert_same_state(ref, port)

    @pytest.mark.parametrize("seed", range(6))
    def test_rank_and_select(self, seed):
        rng = np.random.default_rng(1000 + seed)
        sites, links = _grid(rng, int(rng.integers(2, 16)))
        ref, port, jr, jp = _twins(sites, links, _jobs(rng, 12))
        assert port.rank_sites_batch(jp) == ref.rank_sites_batch(jr)
        assert [port.rank_sites(j) for j in jp] == [ref.rank_sites(j) for j in jr]
        _assert_same_placement(port.select_sites_batch(jp), ref.select_sites_batch(jr))

    def test_sequential_loop_matches_batch(self):
        rng = np.random.default_rng(21)
        sites, links = _grid(rng, 9)
        _, port, _, jobs = _twins(sites, links, _jobs(rng, 30))
        other = P.DianaScheduler(copy.deepcopy(port.sites), dict(port.links), device=CPU)
        seq = [other.place(j) for j in copy.deepcopy(jobs)]
        bat = port.place_batch(jobs)
        assert [d.site for d in seq] == bat.sites
        assert [d.cost for d in seq] == bat.costs.tolist()
        assert [d.job_class for d in seq] == bat.classes

    def test_weights_and_explicit_classes(self):
        rng = np.random.default_rng(11)
        sites, links = _grid(rng, 8)
        w = R.CostWeights(w_queue=0.7, w_work=1.3, w_load=4.0)
        ref, port, jr, jp = _twins(sites, links, _jobs(rng, 9), w)
        classes = [R.JobClass.COMPUTE, R.JobClass.DATA, R.JobClass.BOTH] * 3
        pclasses = [P.JobClass(c.value) for c in classes]
        _assert_same_placement(port.place_batch(jp, pclasses), ref.place_batch(jr, classes))
        _assert_same_state(ref, port)

    def test_tie_break_and_feedback(self):
        sites = {n: R.SiteState(name=n, capacity=100.0, queue_length=5.0, waiting_work=10.0, load=0.2)
                 for n in ("zeta", "alpha", "mid")}
        links = {n: R.NetworkLink(bandwidth_Bps=1e9, loss_rate=0.001) for n in sites}
        jobs = [R.Job(user="u", compute_work=5.0, input_bytes=2e9) for _ in range(6)]
        ref, port, jr, jp = _twins(sites, links, jobs)
        got = port.place_batch(jp)
        _assert_same_placement(got, ref.place_batch(jr))
        assert got.sites[0] == "zeta"

    def test_dead_site_and_commit_release(self):
        rng = np.random.default_rng(3)
        sites, links = _grid(rng, 6, dead_fraction=0.0)
        first = R.DianaScheduler(copy.deepcopy(sites), dict(links)).select_site(
            R.Job(user="u", compute_work=10.0)).site
        sites[first].alive = False
        ref, port, jr, jp = _twins(sites, links, [R.Job(user="u", compute_work=10.0) for _ in range(4)])
        got = port.place_batch(jp)
        _assert_same_placement(got, ref.place_batch(jr))
        assert first not in got.sites
        for a, b in zip(jr, jp):
            ref.complete(a)
            port.complete(b)
        _assert_same_state(ref, port)

    def test_hier_mode_names_its_roadmap_item(self):
        """mode="hier" (ROADMAP.md queue A, step 7) now runs and decides
        what the reference decides; any other mode still raises."""
        ref, port, jr, jp = _twins(*_grid(np.random.default_rng(0), 3), [R.Job(user="u")])
        for call in ("select_sites_batch", "place_batch"):
            with pytest.raises(ValueError, match="'flat' or 'hier'"):
                getattr(port, call)(jp, mode="tiers")
            _assert_same_placement(getattr(port, call)(jp, mode="hier"),
                                   getattr(ref, call)(jr, mode="hier"))

    @pytest.mark.parametrize("call", ["select_sites_batch", "place_batch"])
    @pytest.mark.parametrize("seed", range(3))
    def test_hier_mode_matches_reference(self, call, seed):
        """mode="hier" through a dict of tiers: the reference's choices,
        costs and (for place_batch) final site state."""
        rng = np.random.default_rng(40 + seed)
        sites, links = _grid(rng, 30)
        tiers = {n: f"t{i % 4}" for i, n in enumerate(sites) if i % 7}
        ref, port, jr, jp = _twins(sites, links, _jobs(rng, 60))
        _assert_same_placement(getattr(port, call)(jp, mode="hier", tiers=tiers),
                               getattr(ref, call)(jr, mode="hier", tiers=tiers))
        _assert_same_state(ref, port)


def _groups(seed, n=5):
    r = np.random.default_rng(seed)
    return [
        R.BulkGroup(
            user=f"u{g}",
            jobs=[R.Job(user=f"u{g}", t=1.0, compute_work=float(r.uniform(0.5, 5)),
                        input_bytes=float(r.uniform(0, 5e9)))
                  for _ in range(int(r.integers(1, 60)))],
            group_id=f"g{g}",
            division_factor=int(r.integers(1, 5)),
        )
        for g in range(n)
    ]


def _port_groups(groups):
    return [
        P.BulkGroup(user=g.user, jobs=P.state_from_reference({}, {}, g.jobs).jobs,
                    group_id=g.group_id, division_factor=g.division_factor,
                    output_location=g.output_location, submit_site=g.submit_site)
        for g in groups
    ]


class TestBulk:
    @pytest.mark.parametrize("seed", range(6))
    def test_schedule_groups(self, seed):
        rng = np.random.default_rng(seed)
        sites, links = _grid(rng, 8)
        ref, port, _, _ = _twins(sites, links, [])
        rb, pb = R.BulkScheduler(ref), P.BulkScheduler(port)
        groups = _groups(seed + 1, n=12)
        expect = rb.schedule_groups(groups)
        got = pb.schedule_groups(_port_groups(groups))
        for a, b in zip(expect, got):
            assert (b.group_id, b.split, b.sites, b.output_location) == (
                a.group_id, a.split, a.sites, a.output_location)
            assert {s: [j.job_id for j in js] for s, js in b.assignments.items()} == {
                s: [j.job_id for j in js] for s, js in a.assignments.items()}
        _assert_same_state(ref, port)

    def test_schedule_groups_equals_one_by_one(self):
        rng = np.random.default_rng(4)
        sites, links = _grid(rng, 8)
        _, port, _, _ = _twins(sites, links, [])
        other = P.DianaScheduler(copy.deepcopy(port.sites), dict(port.links), device=CPU)
        groups = _groups(5)
        bat = P.BulkScheduler(port).schedule_groups(_port_groups(groups))
        seq = [P.BulkScheduler(other).schedule_group(g) for g in _port_groups(groups)]
        assert [(a.split, a.sites) for a in seq] == [(b.split, b.sites) for b in bat]
        assert P.BulkScheduler(port).schedule_groups([]) == []

    @pytest.mark.parametrize("k,alloc,span", [
        (1, {"D": 10_000}, 16.67),
        (2, {"C": 4_000, "D": 6_000}, 10.00),
        (10, {"A": 769, "B": 1539, "C": 3077, "D": 4615}, 7.69),
    ])
    def test_fig4(self, k, alloc, span):
        got = P.allocate_proportional(10_000, k, FIG4_CAPS)
        assert got == alloc == R.allocate_proportional(10_000, k, FIG4_CAPS)
        mk = P.average_makespan(got, FIG4_CAPS)
        assert mk == R.average_makespan(got, FIG4_CAPS)
        assert round(mk, 2) == span

    def test_fig4_through_schedule_groups(self):
        sites = {n: R.SiteState(name=n, capacity=c) for n, c in FIG4_CAPS.items()}
        links = {n: R.NetworkLink(bandwidth_Bps=1e9, loss_rate=0.001) for n in FIG4_CAPS}
        ref, port, _, _ = _twins(sites, links, [])
        jobs = [R.Job(user="u", t=1, compute_work=1.0) for _ in range(10_000)]
        group = R.BulkGroup(user="u", jobs=jobs, group_id="fig4", division_factor=10)
        a = R.BulkScheduler(ref).schedule_groups([group])[0]
        b = P.BulkScheduler(port).schedule_groups(_port_groups([group]))[0]
        counts = {s: len(js) for s, js in b.assignments.items()}
        assert counts == {s: len(js) for s, js in a.assignments.items()}
        assert counts == {"A": 769, "B": 1539, "C": 3077, "D": 4615} and b.split
        _assert_same_state(ref, port)

    def test_zero_capacity_even_split(self):
        for n, k in ((10, 2), (7, 3)):
            caps = {"a": 0.0, "b": 0.0, "c": 0.0}
            got = P.allocate_proportional(n, k, caps)
            assert got == R.allocate_proportional(n, k, caps)
            assert sum(got.values()) == n and max(got.values()) - min(got.values()) <= 1

    def test_no_sites_raises(self):
        with pytest.raises(ValueError, match="no sites"):
            P.allocate_proportional(10, 2, {})

    @pytest.mark.parametrize("seed", range(4))
    def test_allocate_proportional_random(self, seed):
        rng = np.random.default_rng(seed)
        caps = {f"s{i}": float(rng.integers(10, 1000)) for i in range(int(rng.integers(1, 8)))}
        num, k = int(rng.integers(1, 100_000)), int(rng.integers(1, 8))
        assert P.allocate_proportional(num, k, caps) == R.allocate_proportional(num, k, caps)

    def test_routing(self):
        class Peer:
            def __init__(self, name, home_sites):
                self.name, self.home_sites = name, home_sites

            def schedule_group(self, group, max_group_fraction, now=None):
                return (self.name, group.group_id, max_group_fraction, now)

        peers = [Peer("p0", {"x"}), Peer("p1", {"y"}), Peer("p2", set())]
        groups = [P.BulkGroup(user=u, jobs=[], group_id=u, submit_site=s)
                  for u, s in (("alice", "y"), ("bob", None), ("carol", "zz"))]
        for g in groups:
            assert P.stable_user_peer(g.user, peers) is R.stable_user_peer(g.user, peers)
        routed = P.route_groups(groups, peers, 0.5, now=3.0)
        assert routed[0] == (peers[1], ("p1", "alice", 0.5, 3.0))
        assert [p for p, _ in routed[1:]] == [R.stable_user_peer(u, peers) for u in ("bob", "carol")]
        with pytest.raises(ValueError):
            P.stable_user_peer("u", [])

    def test_outputs_aggregate(self):
        port = P.DianaScheduler({n: P.SiteState(name=n, capacity=c) for n, c in FIG4_CAPS.items()},
                                {n: P.NetworkLink(bandwidth_Bps=1e9, loss_rate=0.001) for n in FIG4_CAPS},
                                device=CPU)
        bulk = P.BulkScheduler(port)
        g = P.BulkGroup(user="u", jobs=[P.Job(user="u", t=1, output_bytes=100.0) for _ in range(2000)],
                        group_id="g", division_factor=4, output_location="se01")
        placement = bulk.schedule_group(g)
        assert placement.output_location == "se01" and placement.split
        assert sum(bulk.aggregate_outputs(placement).values()) == 2000 * 100.0


class TestPacksAndInterop:
    def test_state_carried_exactly(self):
        rng = np.random.default_rng(8)
        sites, links = _grid(rng, 5)
        sites["s0"].free_slots = 0.0
        jobs = _jobs(rng, 4)
        w = R.CostWeights(w_queue=0.1, w_work=0.2, w_load=0.3)
        st = P.state_from_reference(sites, links, jobs, w)
        assert list(st.sites) == list(sites)
        for n in sites:
            assert vars(st.sites[n]) == vars(sites[n])
            assert st.links[n].__dict__ == links[n].__dict__
        assert [vars(j) for j in st.jobs] == [vars(j) for j in jobs]
        assert (st.weights.w_queue, st.weights.w_work, st.weights.w_load) == (0.1, 0.2, 0.3)
        assert P.state_from_reference(sites, links).jobs == []

    def test_from_arrays_equals_from_scheduler(self):
        rng = np.random.default_rng(2)
        sites, links = _grid(rng, 11)
        sr = R.batch.SitePack.from_scheduler(sites, links)
        cols = {f: getattr(sr, f) for f in R.batch.PACK_FIELDS}
        sp = P.SitePack.from_arrays(sr.names, alive=sr.alive, device=CPU, **cols)
        st = P.state_from_reference(sites, links)
        sp2 = P.SitePack.from_scheduler(st.sites, st.links, device=CPU)
        assert sp.names == sp2.names == sr.names
        assert torch.equal(sp.pack_rows(), sp2.pack_rows())
        assert np.array_equal(sp.pack_rows().numpy(), sr.pack_rows())
        assert np.array_equal(sp.pack_rows([3, 1]).numpy(), sr.pack_rows(np.array([3, 1])))
        assert torch.equal(sp.alive, torch.from_numpy(sr.alive))
        with pytest.raises(TypeError):
            P.SitePack.from_arrays(sr.names, device=CPU, cap=sr.cap)

    def test_set_columns_and_refresh(self):
        rng = np.random.default_rng(5)
        sites, links = _grid(rng, 6, dead_fraction=0.0)
        st = P.state_from_reference(sites, links)
        sr = R.batch.SitePack.from_scheduler(sites, links)
        sp = P.SitePack.from_scheduler(st.sites, st.links, device=CPU)
        rows = rng.uniform(0, 50, size=(8, 2))
        for pack in (sr, sp):
            pack.set_columns(np.array([4, 1]), rows, alive=np.array([False, True]), fields=("queue", "load"))
        assert np.array_equal(sp.pack_rows().numpy(), sr.pack_rows())
        assert np.array_equal(sp.alive.numpy(), sr.alive)
        sites["s2"].queue_length = 321.0
        st.sites["s2"].queue_length = 321.0
        sr.refresh_dynamic(sites)
        sp.refresh_dynamic(st.sites)
        assert np.array_equal(sp.pack_rows().numpy(), sr.pack_rows())
        with pytest.raises(KeyError, match="ghost"):
            sp.refresh_dynamic(st.sites, only=["s0", "ghost"])
        st.sites["s1"].waiting_work = 99.0
        with pytest.warns(UserWarning, match="ghost"):
            sp.refresh_dynamic(st.sites, only=["s1", "ghost"], missing="warn")
        assert float(sp.work[1]) == 99.0
        with pytest.raises(ValueError):
            sp.refresh_dynamic(st.sites, only=["ghost"], missing="skip")
        st.sites["s3"].load = 0.125
        sp.refresh_from(lambda n: st.sites[n], only=["s3"])
        assert float(sp.load[3]) == 0.125

    def test_engine_replay_updates_pack(self):
        rng = np.random.default_rng(6)
        sites, links = _grid(rng, 7)
        jobs = _jobs(rng, 15)
        st = P.state_from_reference(sites, links, jobs)
        sr, jr = R.batch.SitePack.from_scheduler(sites, links), R.batch.JobPack.from_jobs(jobs)
        sp = P.SitePack.from_scheduler(st.sites, st.links, device=CPU)
        jp = P.PlacementEngine().pack_jobs(st.jobs, device=CPU)
        _assert_same_placement(P.PlacementEngine().replay(jp, sp), R.PlacementEngine().replay(jr, sr))
        assert np.array_equal(sp.pack_rows().numpy(), sr.pack_rows())

    def test_scalar_costs(self):
        rng = np.random.default_rng(13)
        sites, links = _grid(rng, 5)
        st = P.state_from_reference(sites, links)
        d = R.JobDemand(compute_work=3.0, input_bytes=5e9, output_bytes=1e8, executable_bytes=7.0)
        pd = P.JobDemand(compute_work=3.0, input_bytes=5e9, output_bytes=1e8, executable_bytes=7.0)
        for n in sites:
            assert P.total_cost(pd, st.sites[n], st.links[n]) == R.total_cost(d, sites[n], links[n])
            assert P.mathis_throughput(st.links[n]) == R.mathis_throughput(links[n])
        with pytest.raises(ValueError):
            P.SiteState(name="x", capacity=0.0)
