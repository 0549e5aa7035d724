"""The ported P2P layer (``repro_torch.core.p2p``) against the reference,
on the host: tests/core/test_p2p.py's world views, epochs, gossip, bulk
routing and delta protocol, each run through both packages from one
seeded state, plus single-peer ≡ ``DianaScheduler`` for place, rank and
select (the bulk bench's 10,000 jobs × 256 sites included) and the
row-versioned ``merge_packed_rows``."""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core import batch as RB
from repro_torch.core import batch as PB

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
from bulk_placement_bench import _build as bench_build  # noqa: E402

CPU = "cpu"


def _grid(rng, n_sites, dead_fraction=0.2):
    """tests/core/test_p2p.py's grid, in reference objects."""
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
            loss_rate=0.0 if rng.uniform() < 0.3 else float(rng.uniform(1e-4, 0.05)),
            rtt_s=float(rng.uniform(0.001, 0.3)),
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


def _port_state(sites, links, jobs=None):
    st = P.state_from_reference(sites, links, jobs)
    return st.sites, st.links, st.jobs


def _ring(mod, sites, links, n_peers, **kw):
    names = list(sites)
    return [
        mod.PeerScheduler(home=names[i], sites=copy.deepcopy(sites), links=dict(links),
                          home_sites=names[i::n_peers], order=names, **kw)
        for i in range(min(n_peers, len(names)))
    ]


def _rings(seed, n_sites, n_peers, dead_fraction=0.0):
    """The same peer ring in both packages (the port's on the host)."""
    rng = np.random.default_rng(seed)
    sites, links = _grid(rng, n_sites, dead_fraction)
    ps, pl, _ = _port_state(sites, links)
    return _ring(R, sites, links, n_peers), _ring(P, ps, pl, n_peers, device=CPU)


def _state(p):
    """A peer's whole world view as plain values (either package)."""
    v = p.view
    cols = [v.cap, v.queue, v.work, v.load, v.bw, v.loss, v.rtt, v.mss, v.alive,
            p.free, p.version, p.stamp, p._dirty, p.home_cols]
    return repr([np.asarray(c).tolist() for c in cols]) + repr(sorted(p.home_names))


def _same(ref_peers, port_peers):
    assert [_state(p) for p in port_peers] == [_state(p) for p in ref_peers]


def _same_placement(got, expect):
    assert got.sites == expect.sites
    assert got.site_indices.tolist() == list(expect.site_indices)
    assert got.costs.tolist() == list(expect.costs)
    assert [c.value for c in got.classes] == [c.value for c in expect.classes]


class TestSinglePeerEquivalence:
    """One peer owning every site places exactly as ``DianaScheduler``,
    and as the reference's single peer."""

    @pytest.mark.parametrize("seed", range(8))
    def test_place_batch_bit_identical(self, seed):
        rng = np.random.default_rng(seed)
        sites, links = _grid(rng, int(rng.integers(2, 24)))
        jobs = _jobs(rng, int(rng.integers(1, 50)))
        ps, pl, pj = _port_state(sites, links, jobs)
        ref = R.single_peer(copy.deepcopy(sites), dict(links))
        diana = P.DianaScheduler(copy.deepcopy(ps), dict(pl), device=CPU)
        peer = P.single_peer(copy.deepcopy(ps), dict(pl), device=CPU)
        jr, jd, jp = copy.deepcopy(jobs), copy.deepcopy(pj), copy.deepcopy(pj)
        expect = ref.place_batch(jr)
        _same_placement(peer.place_batch(jp), expect)
        _same_placement(diana.place_batch(jd), expect)
        assert [j.site for j in jp] == [j.site for j in jr] == [j.site for j in jd]
        for name, st in ref.authoritative.items():
            got = peer.authoritative[name]
            assert (got.queue_length, got.waiting_work) == (st.queue_length, st.waiting_work)
            assert (diana.sites[name].queue_length, diana.sites[name].waiting_work) == (
                st.queue_length, st.waiting_work)
        _same([ref], [peer])

    @pytest.mark.parametrize("seed", range(6))
    def test_rank_and_select_bit_identical(self, seed):
        rng = np.random.default_rng(100 + seed)
        sites, links = _grid(rng, 9)
        jobs = _jobs(rng, 7)
        ps, pl, pj = _port_state(sites, links, jobs)
        ref = R.single_peer(copy.deepcopy(sites), dict(links))
        peer = P.single_peer(copy.deepcopy(ps), dict(pl), device=CPU)
        diana = P.DianaScheduler(copy.deepcopy(ps), dict(pl), device=CPU)
        assert peer.rank_sites_batch(pj) == ref.rank_sites_batch(jobs) == diana.rank_sites_batch(pj)
        _same_placement(peer.select_sites_batch(pj), ref.select_sites_batch(jobs))

    @pytest.mark.parametrize("seed", range(3))
    def test_hier_mode_matches_reference(self, seed):
        rng = np.random.default_rng(200 + seed)
        sites, links = _grid(rng, 20, dead_fraction=0.1)
        jobs = _jobs(rng, 25)
        tiers = {n: f"t{i % 4}" for i, n in enumerate(sites)}
        ps, pl, pj = _port_state(sites, links, jobs)
        ref = R.single_peer(copy.deepcopy(sites), dict(links))
        peer = P.single_peer(copy.deepcopy(ps), dict(pl), device=CPU)
        _same_placement(peer.select_sites_batch(pj, mode="hier", tiers=tiers),
                        ref.select_sites_batch(jobs, mode="hier", tiers=tiers))
        _same_placement(peer.place_batch(copy.deepcopy(pj), mode="hier", tiers=tiers),
                        ref.place_batch(copy.deepcopy(jobs), mode="hier", tiers=tiers))
        # The cached TierPack refreshes narrowly after a merge moves an epoch.
        ref.version[0] += 1
        peer.version[0] += 1
        _same_placement(peer.select_sites_batch(pj, mode="hier", tiers=tiers),
                        ref.select_sites_batch(jobs, mode="hier", tiers=tiers))
        with pytest.raises(ValueError):
            peer.place_batch(pj, mode="tiers")


class TestBenchConfiguration:
    """10,000 jobs × 256 sites, seed 0 (benchmarks/bulk_placement_bench.py):
    the peer API equals the reference's single peer and ``DianaScheduler``
    bit for bit."""

    @pytest.fixture(scope="class")
    def bench(self):
        sites, links, jobs = bench_build(10_000, 256, 0)
        return (sites, links, jobs) + _port_state(sites, links, jobs)

    def test_select_and_rank(self, bench):
        sites, links, jobs, ps, pl, pj = bench
        ref = R.DianaScheduler(copy.deepcopy(sites), dict(links))
        peer = P.single_peer(copy.deepcopy(ps), dict(pl), device=CPU)
        _same_placement(peer.select_sites_batch(pj), ref.select_sites_batch(jobs))
        assert peer.rank_sites_batch(pj) == ref.rank_sites_batch(jobs)

    def test_place_batch(self, bench):
        sites, links, jobs, ps, pl, pj = bench
        ref = R.DianaScheduler(copy.deepcopy(sites), dict(links))
        peer = P.single_peer(copy.deepcopy(ps), dict(pl), device=CPU)
        jr, jp = copy.deepcopy(jobs), copy.deepcopy(pj)
        _same_placement(peer.place_batch(jp), ref.place_batch(jr))
        assert [j.site for j in jp] == [j.site for j in jr]
        for name, st in ref.sites.items():
            got = peer.authoritative[name]
            assert (got.queue_length, got.waiting_work) == (st.queue_length, st.waiting_work)


class TestMergePackedRows:
    """``merge_packed_rows`` against the reference's on random merges:
    newer, equal, older and duplicate columns, protected and reclaimed
    columns, a field subset."""

    @pytest.mark.parametrize("seed", range(10))
    def test_matches_reference(self, seed):
        rng = np.random.default_rng(seed)
        S, k = int(rng.integers(3, 20)), int(rng.integers(1, 30))
        names = [f"s{i}" for i in range(S)]
        cols = {f: rng.uniform(0, 100, S) for f in RB.PACK_FIELDS}
        alive0 = rng.uniform(size=S) > 0.2
        version = rng.integers(0, 4, S).astype(np.int64)
        stamp = rng.uniform(0, 10, S)
        take = rng.integers(0, S, k)
        rows = rng.uniform(0, 100, (8, k))
        new_version = rng.integers(0, 5, k).astype(np.int64)
        new_stamp = np.round(rng.uniform(0, 12, k))
        alive = rng.uniform(size=k) > 0.5
        protect = rng.uniform(size=S) < 0.2
        reclaim = rng.uniform(size=S) < 0.3
        fields = [None, R.p2p.OWNER_FIELDS, R.p2p.QUANT_FIELDS][seed % 3]
        rsp = RB.SitePack(names=names, alive=alive0.copy(), **{f: c.copy() for f, c in cols.items()})
        psp = PB.SitePack.from_arrays(names, device=CPU, alive=alive0, **cols)
        rv, rs = version.copy(), stamp.copy()
        pv, pst = torch.from_numpy(version.copy()), torch.from_numpy(stamp.copy())
        got = PB.merge_packed_rows(psp, pv, pst, take, rows, new_version, new_stamp, alive=alive,
                                   protect=torch.from_numpy(protect), fields=fields,
                                   reclaim=torch.from_numpy(reclaim))
        want = RB.merge_packed_rows(rsp, rv, rs, take, rows, new_version, new_stamp, alive=alive,
                                    protect=protect, fields=fields, reclaim=reclaim)
        assert got.tolist() == want.tolist()
        assert pv.tolist() == rv.tolist()
        assert pst.tolist() == rs.tolist()
        for f in RB.PACK_FIELDS + ("alive",):
            assert getattr(psp, f).tolist() == getattr(rsp, f).tolist(), f


class TestPeerMergeEntries:
    """``PeerScheduler.receive_packed`` and ``refresh_stamps`` against the
    reference's on random sections: home, speculated, unknown and
    repeated names, epochs around the held ones, heartbeats applied in
    turn."""

    @pytest.mark.parametrize("seed", range(8))
    def test_matches_reference(self, seed):
        refs, ports = _rings(seed, 12, 3)
        rng = np.random.default_rng(100 + seed)
        rp, pp = refs[0], ports[0]
        spec = np.flatnonzero(rng.uniform(size=12) < 0.3)
        rp._dirty[spec] = True
        pp._dirty[torch.from_numpy(spec)] = True
        names = list(rp.view.names) + ["elsewhere"]
        for _ in range(4):
            k = int(rng.integers(1, 16))
            pick = [names[i] for i in rng.integers(0, len(names), k)]
            held = [int(rp.version[rp._col[n]]) if n in rp._col else 0 for n in pick]
            versions = np.asarray(held, np.int64) + rng.integers(-1, 2, k)
            stamps = np.round(rng.uniform(0, 12, k))
            section = dict(names=pick, qrows=rng.uniform(0, 100, (3, k)), free=rng.uniform(0, 9, k),
                           alive=rng.uniform(size=k) > 0.3, versions=versions, stamps=stamps)
            assert pp.receive_packed(**section) == rp.receive_packed(**section)
            beats = dict(names=pick[::-1] + pick[:2], versions=np.r_[versions[::-1], versions[:2]],
                         stamps=np.r_[stamps[::-1], stamps[:2] + 1.0])
            assert pp.refresh_stamps(**beats) == rp.refresh_stamps(**beats)
            _same(refs, ports)


class TestWorldView:
    """tests/core/test_p2p.py::TestWorldView, run through both packages."""

    def test_receive_applies_only_newer_epochs(self):
        refs, ports = _rings(0, 4, 2)
        for (p0, p1) in (refs, ports):
            col = p0._col[p1.home]
            p1.authoritative[p1.home].queue_length = 555.0
            p1.refresh_home(now=10.0)
            adverts = p1.adverts()
            assert p0.receive(adverts) >= 1
            assert p0.view.queue[col] == 555.0
            assert p0.version[col] == p1.version[col]
            p0.view.queue[col] = -1.0
            assert p0.receive(adverts) == 0
            assert p0.view.queue[col] == -1.0
        _same(refs, ports)

    def test_hearsay_never_overwrites_home(self):
        refs, ports = _rings(1, 4, 2)
        for mod, (p0, _) in ((R.p2p, refs), (P.p2p, ports)):
            home_col = p0._col[p0.home]
            truth = float(p0.view.queue[home_col])
            fake = mod.SiteAdvert(site=p0.home, row=np.full(8, 7.0), alive=True,
                                  free_slots=1.0, version=10_000, stamp=99.0)
            assert p0.receive([fake]) == 0
            assert p0.view.queue[home_col] == truth
            ghost = mod.SiteAdvert(site="nope", row=np.zeros(8), alive=True,
                                   free_slots=0.0, version=1, stamp=0.0)
            assert p0.receive([ghost]) == 0
        _same(refs, ports)

    def test_staleness_tracks_owner_stamp(self):
        refs, ports = _rings(3, 4, 2)
        out = []
        for p0, p1 in (refs, ports):
            p1.refresh_home(now=50.0)
            p0.receive(p1.adverts())
            stale = p0.staleness(now=80.0)
            for n in p0.home_names:
                assert stale[p0._col[n]] == 0.0
            for n in p1.home_names:
                assert stale[p0._col[n]] == 30.0   # 80 − owner stamp 50
            out.append(np.asarray(stale).tolist())
        assert out[0] == out[1]
        assert isinstance(ports[0].staleness(1.0), torch.Tensor)

    def test_receive_keeps_own_path_measurements(self):
        refs, ports = _rings(16, 4, 2)
        for p0, p1 in (refs, ports):
            c = p0._col[p1.home]
            my_bw, my_rtt = float(p0.view.bw[c]), float(p0.view.rtt[c])
            p1.view.bw[p1._col[p1.home]] = 1.0
            p1.authoritative[p1.home].queue_length = 777.0
            p1.refresh_home(now=1.0)
            assert p0.receive(p1.adverts()) >= 1
            assert p0.view.queue[c] == 777.0
            assert p0.view.bw[c] == my_bw and p0.view.rtt[c] == my_rtt
        _same(refs, ports)

    def test_saturated_site_advertises_zero_free_slots(self):
        sites = {"a": P.SiteState(name="a", capacity=8.0, free_slots=0.0),
                 "b": P.SiteState(name="b", capacity=8.0)}
        links = {n: P.NetworkLink(bandwidth_Bps=1e9) for n in sites}
        pa, pb = _ring(P, sites, links, 2, device=CPU)
        pa.refresh_home(now=1.0)
        pb.receive(pa.adverts())
        assert pb.view_states()["a"].free_slots == 0.0
        assert pb.view_states()["b"].free_slots == 8.0

    def test_duplicate_adverts_keep_highest_epoch(self):
        refs, ports = _rings(15, 4, 2)
        for p0, p1 in (refs, ports):
            p1.authoritative[p1.home].queue_length = 100.0
            p1.refresh_home(now=1.0)
            old = p1.adverts(cols=[p1._col[p1.home]])
            p1.authoritative[p1.home].queue_length = 200.0
            p1.refresh_home(now=2.0)
            new = p1.adverts(cols=[p1._col[p1.home]])
            col = p0._col[p1.home]
            assert p0.receive(new + old) == 1
            assert p0.view.queue[col] == 200.0
            assert p0.version[col] == new[0].version
        _same(refs, ports)

    def test_speculative_rows_are_not_readvertised(self):
        refs, ports = _rings(14, 4, 2)
        for p0, p1 in (refs, ports):
            remote = p1.home
            c = p0._col[remote]
            p0.note_remote_placement(remote, work=5.0)
            assert p0._dirty[c]
            assert remote not in {a.site for a in p0.adverts()}
            p0.note_remote_placement(p0.home, work=5.0)
            assert not p0._dirty[p0._col[p0.home]]
            p1.refresh_home(now=1.0)
            assert p0.receive(p1.adverts()) >= 1
            assert not p0._dirty[c]
            assert remote in {a.site for a in p0.adverts()}
        _same(refs, ports)

    def test_adverts_match_the_reference(self):
        refs, ports = _rings(17, 7, 3)
        for p in refs + ports:
            p.refresh_home(now=3.0)
            p.note_remote_placement(p.view.names[-1], work=2.5)
        for a, b in zip(refs, ports):
            ra, pa = a.adverts(), b.adverts()
            assert [(x.site, x.alive, x.free_slots, x.version, x.stamp, x.row.tolist())
                    for x in pa] == [(x.site, x.alive, x.free_slots, x.version, x.stamp,
                                      x.row.tolist()) for x in ra]
            assert all(not x.row.flags.writeable for x in pa)
            assert [P.p2p.advert_wire_bytes(x) for x in pa] == [R.p2p.advert_wire_bytes(x) for x in ra]

    def test_place_batch_marks_remote_choices_dirty(self):
        sites = {"a": P.SiteState(name="a", capacity=100.0, queue_length=400.0),
                 "b": P.SiteState(name="b", capacity=100.0)}
        links = {n: P.NetworkLink(bandwidth_Bps=1e9) for n in sites}
        pa, _ = _ring(P, sites, links, 2, device=CPU)
        got = pa.place_batch([P.Job(user="u", compute_work=1.0)])
        assert got.sites == ["b"]
        assert pa._dirty[pa._col["b"]]
        assert "b" not in {a.site for a in pa.adverts()}

    def test_stale_view_changes_placement_until_exchange(self):
        sites = {"a": P.SiteState(name="a", capacity=100.0),
                 "b": P.SiteState(name="b", capacity=100.0, queue_length=1.0)}
        links = {n: P.NetworkLink(bandwidth_Bps=1e9) for n in sites}
        pa, pb = _ring(P, sites, links, 2, device=CPU)
        pb.authoritative["b"].queue_length = 500.0
        job = lambda: P.Job(user="u", compute_work=1.0)  # noqa: E731
        assert pa.place_batch([job()]).sites == ["a"]
        pa.view.queue[pa._col["a"]] = 400.0
        assert pa.place_batch([job()]).sites == ["b"]
        P.GossipExchange([pa, pb], device=CPU).round(now=1.0)
        assert pa.place_batch([job()]).sites == ["a"]

    def test_handover_and_adopt_match_the_reference(self):
        refs, ports = _rings(18, 9, 3)
        for peers in (refs, ports):
            for p in peers:
                p.refresh_home(now=5.0)
            peers[0].note_remote_placement(peers[1].home, 3.0)
            grant = peers[1].handover()
            peers[2].adopt(grant)
            peers[2].refresh_home(now=9.0)
            back = peers[2].handover(names=grant["names"][:2])
            peers[1].adopt(back)
            with pytest.raises(KeyError):
                peers[0].handover(names=["not-home"])
        _same(refs, ports)
        g = ports[1].handover()
        assert set(g) == {"names", "states", "version", "stamp", "pub"}
        assert isinstance(g["pub"][g["names"][0]], np.ndarray)


class TestGossipExchange:
    def test_full_mesh_converges_in_one_round(self):
        refs, ports = _rings(4, 6, 3)
        for mod, peers in ((R, refs), (P, ports)):
            for p in peers:
                for n in p.home_names:
                    p.authoritative[n].queue_length = 111.0
            kw = {"device": CPU} if mod is P else {}
            mod.GossipExchange(peers, **kw).round(now=5.0)
            for p in peers:
                assert (p.view.queue == 111.0).all()
        _same(refs, ports)

    def test_latency_delays_application(self):
        _, (p0, p1) = _rings(5, 4, 2)
        p1.authoritative[p1.home].queue_length = 222.0
        ex = P.GossipExchange([p0, p1], latency_s=10.0, device=CPU)
        ex.round(now=0.0)
        col = p0._col[p1.home]
        assert p0.view.queue[col] != 222.0
        assert ex.in_flight > 0 and ex.next_due() == 10.0
        ex.deliver_due(now=10.0)
        assert p0.view.queue[col] == 222.0
        assert ex.in_flight == 2 and ex.next_due() == 20.0
        ex.deliver_due(now=20.0)
        assert ex.in_flight == 0
        assert ex.stats.acks_sent == 2

    def test_hierarchy_fanout_routes_via_representatives(self):
        rng = np.random.default_rng(6)
        sites, links = _grid(rng, 4, dead_fraction=0.0)
        ps, pl, _ = _port_state(sites, links)
        names = list(sites)
        topo = P.GridTopology()
        for n in names[:2]:
            topo.join("east", P.Node(name=n))
        for n in names[2:]:
            topo.join("west", P.Node(name=n))
        peers = [P.PeerScheduler(home=n, sites=copy.deepcopy(ps), links=dict(pl),
                                 home_sites=[n], order=names, device=CPU) for n in names]
        ex = P.GossipExchange(peers, topology=topo, device=CPU)
        assert set(ex.neighbors(1, rnd=1)) == {0}
        assert set(ex.neighbors(0, rnd=1)) == {1, 2}
        p3 = peers[3]
        p3.authoritative[p3.home].queue_length = 333.0
        col = peers[1]._col[p3.home]
        for t in (1.0, 2.0, 3.0):
            ex.round(now=t)
        assert peers[1].view.queue[col] == 333.0

    def test_fanout_cap_rotates(self):
        _, peers = _rings(7, 8, 4)
        ex = P.GossipExchange(peers, fanout=1, device=CPU)
        seen = set()
        for rnd in range(1, 5):
            nbrs = ex.neighbors(0, rnd)
            assert len(nbrs) == 1
            seen.update(nbrs)
        assert seen == {1, 2, 3}

    def test_wire_bytes_accounting(self):
        a = P.p2p.SiteAdvert(site="xy", row=np.zeros(8), alive=True,
                             free_slots=1.0, version=1, stamp=0.0)
        assert P.p2p.advert_wire_bytes(a) == 8 * 8 + 8 + 8 + 8 + 1 + 2
        s = P.p2p.TierSummary(tier="east", stamp=0.0, n=2, n_alive=2, net_min=0.0,
                              eff_max=1.0, cap_max=1.0, comp_min=0.0)
        assert P.p2p.summary_wire_bytes(s) == 8 + 4 * 8 + 2 + 2 + 4

    def test_exchange_on_another_device_is_refused(self):
        _, peers = _rings(8, 4, 2)
        with pytest.raises(ValueError, match="lives on"):
            P.GossipExchange(peers, device="meta")


def _mutating_rounds(mod, peers, ex, seed, rounds=6, latency=False):
    rng = np.random.default_rng(seed)
    for r in range(rounds):
        for p in peers:
            for n in p.home_names:
                if rng.uniform() < 0.6:
                    p.authoritative[n].queue_length = float(rng.integers(0, 500))
                    p.authoritative[n].waiting_work = float(rng.uniform(0, 900))
        if rng.uniform() < 0.3:
            peers[0].note_remote_placement(peers[-1].home, 1.5)
        t = 60.0 * r
        ex.deliver_due(t)
        ex.round(now=t)
    ex.deliver_due(1e9)


class TestExchangeMatchesReference:
    """Whole exchanges through both packages from one seeded state: the
    stats (rounds, adverts, bytes, heartbeats, acks, full syncs) and
    every peer's world view equal after mutating rounds."""

    @pytest.mark.parametrize("wire,quant,fanout,latency,topo,summaries", [
        ("delta", "f32", None, 0.0, False, False),
        ("delta", "f16", None, 3.0, False, False),
        ("delta", "f32", 1, 2.0, False, False),
        ("delta", "f32", None, 2.0, True, False),
        ("delta", "f32", None, 0.0, True, True),
        ("full", "f32", None, 0.0, False, False),
        ("full", "f32", 2, 5.0, True, True),
    ])
    def test_stats_and_views(self, wire, quant, fanout, latency, topo, summaries):
        rng = np.random.default_rng(40)
        sites, links = _grid(rng, 12, dead_fraction=0.1)
        ps, pl, _ = _port_state(sites, links)
        names = list(sites)
        out = []
        for mod, st, lk, kw in ((R, sites, links, {}), (P, ps, pl, {"device": CPU})):
            topology = None
            if topo:
                topology = mod.GridTopology()
                for i, n in enumerate(names):
                    topology.join(f"root{i % 3}", mod.Node(name=n))
            peers = _ring(mod, st, lk, 5, **kw)
            ex = mod.GossipExchange(peers, topology=topology, latency_s=latency, fanout=fanout,
                                    wire=wire, quant=quant, full_sync_every=3,
                                    summaries=summaries, **kw)
            _mutating_rounds(mod, peers, ex, 41)
            out.append((ex.stats.as_dict(), [_state(p) for p in peers],
                        [sorted(p.tier_summaries.items()) for p in peers]))
        assert repr(out[1][2]) == repr(out[0][2])
        assert out[1][0] == out[0][0]
        assert out[1][1] == out[0][1]


class TestBulkRouting:
    def test_route_groups_places_as_the_reference(self):
        refs, ports = _rings(10, 6, 3)
        routed = []
        for mod, peers in ((R, refs), (P, ports)):
            groups = [
                mod.BulkGroup(user=f"u{i}", group_id=f"g{i}", division_factor=2,
                              submit_site=peers[i % len(peers)].home,
                              jobs=[mod.Job(user=f"u{i}", t=1.0, compute_work=3.0)
                                    for _ in range(20)])
                for i in range(4)
            ]
            out = mod.route_groups(groups, peers)
            assert all(peer is mod.submitting_peer(g, peers) for (peer, _), g in zip(out, groups))
            routed.append([(peers.index(peer), pl.split,
                            {s: len(js) for s, js in pl.assignments.items()})
                           for peer, pl in out])
        assert routed[0] == routed[1]
        _same(refs, ports)

    def test_unknown_submit_site_hashes_stably(self):
        _, peers = _rings(9, 6, 3)
        g = P.BulkGroup(user="bart", jobs=[P.Job(user="bart")], group_id="g1",
                        submit_site="not-a-site")
        assert P.submitting_peer(g, peers) is P.submitting_peer(g, peers)

    def test_single_peer_group_matches_bulk_scheduler(self):
        rng = np.random.default_rng(11)
        sites, links = _grid(rng, 6, dead_fraction=0.0)
        ps, pl, _ = _port_state(sites, links)
        mk = lambda: P.BulkGroup(  # noqa: E731
            user="u", group_id="g", division_factor=3,
            jobs=[P.Job(user="u", t=1.0, compute_work=2.0) for _ in range(40)])
        ref = P.BulkScheduler(P.DianaScheduler(copy.deepcopy(ps), dict(pl), device=CPU)
                              ).schedule_group(mk())
        got = P.single_peer(copy.deepcopy(ps), dict(pl), device=CPU).schedule_group(mk())
        assert ref.split == got.split
        assert {s: len(js) for s, js in ref.assignments.items()} == {
            s: len(js) for s, js in got.assignments.items()}


class TestPeerSchedulerValidation:
    def test_home_must_be_in_home_sites(self):
        rng = np.random.default_rng(12)
        sites, links, _ = _port_state(*_grid(rng, 3, dead_fraction=0.0))
        names = list(sites)
        with pytest.raises(ValueError):
            P.PeerScheduler(home=names[0], sites=sites, links=links, home_sites=[names[1]],
                            device=CPU)

    def test_unknown_home_site_raises(self):
        rng = np.random.default_rng(13)
        sites, links, _ = _port_state(*_grid(rng, 3, dead_fraction=0.0))
        with pytest.raises(KeyError):
            P.PeerScheduler(home="ghost", sites=sites, links=links, device=CPU)


class TestRefreshHomeEpochs:
    """An epoch never opens without a stamp, and opens only on a change."""

    def _pair(self, seed):
        return _rings(seed, 4, 2)[1]

    def test_content_only_refresh_moves_neither_version_nor_stamp(self):
        p0, _ = self._pair(20)
        c = p0._col[p0.home]
        v0, s0 = p0.version.clone(), p0.stamp.clone()
        p0.authoritative[p0.home].queue_length = 999.0
        p0.refresh_home(now=None)
        assert p0.view.queue[c] == 999.0
        assert torch.equal(p0.version, v0) and torch.equal(p0.stamp, s0)

    def test_epoch_opens_with_the_stamp_on_change(self):
        p0, _ = self._pair(21)
        c = p0._col[p0.home]
        v = int(p0.version[c])
        p0.authoritative[p0.home].queue_length = 123.0
        p0.refresh_home(now=42.0)
        assert p0.version[c] == v + 1 and p0.stamp[c] == 42.0

    def test_unchanged_remeasurement_keeps_epoch_but_restamps(self):
        p0, _ = self._pair(22)
        c = p0._col[p0.home]
        p0.refresh_home(now=10.0)
        v = int(p0.version[c])
        p0.refresh_home(now=20.0)
        assert p0.version[c] == v and p0.stamp[c] == 20.0

    def test_content_only_then_stamped_refresh_opens_one_epoch(self):
        p0, _ = self._pair(23)
        c = p0._col[p0.home]
        v = int(p0.version[c])
        p0.authoritative[p0.home].queue_length = 7.0
        p0.refresh_home(now=None)
        p0.refresh_home(now=5.0)
        assert p0.version[c] == v + 1 and p0.stamp[c] == 5.0

    def test_dirty_tracking_and_states_match_the_reference(self):
        refs, ports = _rings(24, 6, 2)
        for peers in (refs, ports):
            p0 = peers[0]
            store = {n: copy.deepcopy(p0.authoritative[n]) for n in p0.home_names}
            p0.state_provider = store.__getitem__
            p0.enable_home_dirty_tracking()
            p0.refresh_home()
            store[p0.home].queue_length = 31.0
            p0.refresh_home()                       # not marked: no re-read
            p0.mark_home_dirty(p0.home)
            p0.mark_home_dirty("foreign")
            p0.refresh_home()
            p0.refresh_home(now=7.0)
            with pytest.raises(KeyError):
                p0.refresh_home(states={peers[1].home: store[p0.home]})
        _same(refs, ports)


class TestDeltaProtocol:
    """tests/core/test_p2p.py::TestDeltaProtocol on the port."""

    def _mesh(self, seed, n_sites=6, n_peers=3, **kw):
        _, peers = _rings(seed, n_sites, n_peers)
        return peers, P.GossipExchange(peers, device=CPU, **kw)

    def test_invalid_wire_args_raise(self):
        peers, _ = self._mesh(30)
        for kw in ({"wire": "morse"}, {"quant": "f8"}, {"full_sync_every": 0}):
            with pytest.raises(ValueError):
                P.GossipExchange(peers, device=CPU, **kw)

    def test_first_round_full_syncs_and_converges(self):
        peers, ex = self._mesh(31)
        for p in peers:
            for n in p.home_names:
                p.authoritative[n].queue_length = 111.0
        ex.round(now=5.0)
        for p in peers:
            assert (p.view.queue == 111.0).all()
        assert ex.stats.full_syncs == len(peers) * (len(peers) - 1)

    def test_steady_state_sends_nothing_but_heartbeats(self):
        peers, ex = self._mesh(32)
        ex.round(now=0.0)
        sent = ex.stats.adverts_sent
        ex.round(now=60.0)
        ex.round(now=120.0)
        assert ex.stats.adverts_sent == sent
        assert ex.stats.heartbeats_sent > 0
        assert ex.stats.acks_sent == ex.stats.deliveries

    def test_single_change_ships_a_single_column(self):
        peers, ex = self._mesh(33, n_peers=2)
        ex.round(now=0.0)
        sent = ex.stats.adverts_sent
        peers[1].authoritative[peers[1].home].queue_length = 777.0
        ex.round(now=60.0)
        assert ex.stats.adverts_sent == sent + 1
        assert peers[0].view.queue[peers[0]._col[peers[1].home]] == 777.0

    def test_heartbeats_keep_stable_rows_fresh(self):
        peers, ex = self._mesh(34, n_peers=2)
        p0, p1 = peers
        for t in (0.0, 60.0, 120.0):
            ex.round(now=t)
        assert float(p0.staleness(now=130.0)[p0._col[p1.home]]) == pytest.approx(10.0)

    def test_periodic_full_sync_rejoin(self):
        peers, ex = self._mesh(35, n_peers=2, full_sync_every=2)
        ex.round(now=0.0)
        assert ex.stats.full_syncs == 2
        ex.round(now=60.0)
        assert ex.stats.full_syncs == 2
        ex.round(now=120.0)
        assert ex.stats.full_syncs == 4
        peers[1].authoritative[peers[1].home].queue_length = 888.0
        ex2 = P.GossipExchange(peers, device=CPU)
        ex2.round(now=180.0)
        assert ex2.stats.full_syncs == 2
        assert peers[0].view.queue[peers[0]._col[peers[1].home]] == 888.0

    @pytest.mark.parametrize("seed", range(4))
    def test_delta_views_match_full_wire(self, seed):
        rng = np.random.default_rng(seed)
        sites, links, _ = _port_state(*_grid(rng, 6, dead_fraction=0.0))
        pf = _ring(P, sites, links, 3, device=CPU)
        pd = _ring(P, sites, links, 3, device=CPU)
        exf = P.GossipExchange(pf, wire="full", device=CPU)
        exd = P.GossipExchange(pd, wire="delta", device=CPU)
        for rnd in range(4):
            mut = int(rng.integers(0, len(pf)))
            q = float(rng.integers(0, 500))
            for peers in (pf, pd):
                p = peers[mut]
                p.authoritative[p.home].queue_length = q
            exf.round(now=60.0 * rnd)
            exd.round(now=60.0 * rnd)
        for a, b in zip(pf, pd):
            assert torch.equal(a.version, b.version) and torch.equal(a.stamp, b.stamp)
            torch.testing.assert_close(b.view.queue, a.view.queue, rtol=2**-23, atol=0)
            torch.testing.assert_close(b.view.work, a.view.work, rtol=2**-23, atol=0)
            torch.testing.assert_close(b.free, a.free, rtol=2**-23, atol=0)
            assert torch.equal(a.view.alive, b.view.alive)

    def test_delta_bytes_are_a_fraction_of_full(self):
        rng = np.random.default_rng(36)
        sites, links, _ = _port_state(*_grid(rng, 24, dead_fraction=0.0))
        exf = P.GossipExchange(_ring(P, sites, links, 4, device=CPU), wire="full", device=CPU)
        exd = P.GossipExchange(_ring(P, sites, links, 4, device=CPU), wire="delta", device=CPU)
        for rnd in range(12):
            exf.round(now=60.0 * rnd)
            exd.round(now=60.0 * rnd)
        assert exd.stats.bytes_sent * 5 < exf.stats.bytes_sent
