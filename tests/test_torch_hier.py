"""Two-level ("hier") placement, ported.

The sweeps of tests/core/test_hier.py run on the port (on the host):
hier ≡ flat inside the port, bit for bit. Beside them the port is held
to the reference: the same ``TierPack`` planes and extrema, the same
``hier_select``/``hier_replay`` choices, costs and pack write-back, and
the scheduler's ``mode="hier"``.
"""
import copy

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                      # offline CI: vendored shim
    from _hypothesis_compat import given, settings, strategies as st

import repro.core as R
import repro.core.batch as RB
import repro.core.migration as RM
import repro_torch.core as P
import repro_torch.core.batch as PB
import repro_torch.core.migration as PM

CPU = "cpu"
TIER_FIELDS = ("net64", "eff64", "net32", "eff32", "cap32",
               "net_min", "eff_max", "eff_min", "cap_max", "cap_min")


def _grid(rng, n_sites, dead_fraction=0.2):
    """tests/core/test_hier.py's grid, in reference objects."""
    sites, links = {}, {}
    for i in range(n_sites):
        name = f"s{i:03d}"
        sites[name] = R.SiteState(
            name=name, capacity=float(rng.integers(10, 2000)),
            queue_length=float(rng.integers(0, 100)),
            waiting_work=float(rng.uniform(0, 1000)),
            load=float(rng.uniform(0, 1)),
            alive=bool(rng.uniform() > dead_fraction),
        )
        links[name] = R.NetworkLink(
            bandwidth_Bps=float(rng.uniform(1e6, 1e10)),
            loss_rate=0.0 if rng.uniform() < 0.3 else float(rng.uniform(1e-4, 0.05)),
            rtt_s=float(rng.uniform(0.001, 0.3)),
        )
    if not any(s.alive for s in sites.values()):
        next(iter(sites.values())).alive = True
    return sites, links


def _jobs(rng, n):
    """Zero-byte and zero-work rows, heavy-tailed sizes."""
    return [
        R.Job(user=f"u{i % 3}",
              compute_work=float(rng.choice([0.0, rng.uniform(0.1, 200)])),
              input_bytes=float(rng.choice([0.0, rng.uniform(0, 50e9)])),
              output_bytes=float(rng.choice([0.0, rng.uniform(0, 1e9)])))
        for i in range(n)
    ]


def _skewed_tiers(rng, names, n_tiers):
    if n_tiers <= 1:
        return {n: "t0" for n in names}
    weights = rng.uniform(0.05, 1.0, n_tiers) ** 3
    weights /= weights.sum()
    assignment = rng.choice(n_tiers, size=len(names), p=weights)
    return {n: f"t{int(t)}" for n, t in zip(names, assignment)}


def _weights(rng):
    return R.CostWeights(w_queue=float(rng.uniform(0, 2)), w_work=float(rng.uniform(0, 2)),
                         w_load=float(rng.uniform(0, 2)))


def _port(sites, links, jobs, weights):
    st_ = P.state_from_reference(sites, links, jobs, weights)
    sp = P.SitePack.from_scheduler(st_.sites, st_.links, device=CPU)
    return sp, P.JobPack.from_jobs(st_.jobs, device=CPU), st_.weights


def _same(got, expect):
    assert got.sites == list(expect.sites)
    assert got.site_indices.tolist() == list(expect.site_indices)
    assert got.costs.tolist() == list(expect.costs)


class TestHierEquivalence:
    """hier ≡ flat in the port (the reference suite's sweeps)."""

    @given(seed=st.integers(0, 100_000), n_sites=st.integers(2, 64),
           n_tiers=st.integers(1, 9), n_jobs=st.integers(1, 40))
    @settings(max_examples=40, deadline=None)
    def test_select_bit_identical_to_flat(self, seed, n_sites, n_tiers, n_jobs):
        rng = np.random.default_rng(seed)
        sites, links = _grid(rng, n_sites)
        w = _weights(rng)
        tiers = _skewed_tiers(rng, list(sites), n_tiers)
        sp, jp, pw = _port(sites, links, _jobs(rng, n_jobs), w)
        tp = P.TierPack.from_site_pack(sp, tiers)
        flat = PB.batched_argmin(PB.batched_cost_matrix(jp, sp, pw), sp)
        hier = P.hier_select(jp, copy.deepcopy(sp), tp, pw)
        assert hier.sites == flat.sites
        assert hier.costs.tolist() == flat.costs.tolist()

    @given(seed=st.integers(0, 100_000), n_sites=st.integers(2, 48),
           n_tiers=st.integers(1, 7), n_jobs=st.integers(1, 40))
    @settings(max_examples=40, deadline=None)
    def test_replay_bit_identical_to_flat(self, seed, n_sites, n_tiers, n_jobs):
        rng = np.random.default_rng(seed)
        sites, links = _grid(rng, n_sites)
        w = _weights(rng)
        tiers = _skewed_tiers(rng, list(sites), n_tiers)
        jobs = _jobs(rng, n_jobs)
        spA, jpA, pw = _port(sites, links, jobs, w)
        spB, jpB, _ = _port(sites, links, jobs, w)
        tp = P.TierPack.from_site_pack(spB, tiers)
        flat = P.replay_on_pack(jpA, spA, pw)
        hier = P.hier_replay(jpB, spB, tp, pw)
        assert hier.sites == flat.sites
        assert hier.costs.tolist() == flat.costs.tolist()
        assert torch.equal(spA.queue, spB.queue) and torch.equal(spA.work, spB.work)

    def test_degenerate_single_tier_is_flat(self):
        rng = np.random.default_rng(5)
        sites, links = _grid(rng, 24, dead_fraction=0.0)
        w = _weights(rng)
        sp, jp, pw = _port(sites, links, _jobs(rng, 30), w)
        tp = P.TierPack.from_site_pack(sp, None)
        assert len(tp.labels) == 1
        flat = PB.batched_argmin(PB.batched_cost_matrix(jp, sp, pw), sp)
        hier = P.hier_select(jp, sp, tp, pw)
        assert hier.sites == flat.sites and hier.costs.tolist() == flat.costs.tolist()

    @given(seed=st.integers(0, 100_000))
    @settings(max_examples=25, deadline=None)
    def test_scheduler_hier_mode_matches_flat(self, seed):
        rng = np.random.default_rng(seed)
        sites, links = _grid(rng, 20, dead_fraction=0.1)
        names = sorted(sites)
        topo = P.GridTopology()
        for i, n in enumerate(names):
            topo.join(f"root{i % 4}", P.Node(name=n))
        st_ = P.state_from_reference(sites, links, _jobs(rng, 25))
        dA = P.DianaScheduler(copy.deepcopy(st_.sites), dict(st_.links), device=CPU)
        dB = P.DianaScheduler(copy.deepcopy(st_.sites), dict(st_.links), topology=topo, device=CPU)
        a = dA.place_batch(copy.deepcopy(st_.jobs))
        b = dB.place_batch(copy.deepcopy(st_.jobs), mode="hier")
        assert a.sites == b.sites and a.costs.tolist() == b.costs.tolist()
        for n in names:
            assert (dA.sites[n].queue_length, dA.sites[n].waiting_work) == \
                (dB.sites[n].queue_length, dB.sites[n].waiting_work)

    def test_bad_mode_rejected(self):
        rng = np.random.default_rng(0)
        sites, links = _grid(rng, 4, dead_fraction=0.0)
        st_ = P.state_from_reference(sites, links, _jobs(rng, 2))
        d = P.DianaScheduler(st_.sites, st_.links, device=CPU)
        for call in (d.select_sites_batch, d.place_batch):
            with pytest.raises(ValueError):
                call(st_.jobs, mode="tiered")


class TestTierPackRefresh:
    @given(seed=st.integers(0, 100_000), n_sites=st.integers(3, 40),
           n_tiers=st.integers(1, 6), n_dirty=st.integers(1, 10))
    @settings(max_examples=30, deadline=None)
    def test_narrowed_refresh_matches_rebuild(self, seed, n_sites, n_tiers, n_dirty):
        rng = np.random.default_rng(seed)
        sites, links = _grid(rng, n_sites)
        tiers = _skewed_tiers(rng, list(sites), n_tiers)
        sp, _, _ = _port(sites, links, [], None)
        tp = P.TierPack.from_site_pack(sp, tiers)
        dirty = rng.choice(n_sites, size=min(n_dirty, n_sites), replace=False)
        for c in dirty:
            sp.bw[c] = float(rng.uniform(1e6, 1e10))
            sp.loss[c] = float(rng.uniform(0, 0.05))
            sp.rtt[c] = float(rng.uniform(0.001, 0.3))
            sp.cap[c] = float(rng.integers(10, 2000))
        tp.refresh(sp, np.asarray(dirty, np.int64))
        fresh = P.TierPack.from_site_pack(sp, tiers)
        for f in TIER_FIELDS:
            assert torch.equal(getattr(tp, f), getattr(fresh, f)), f

    @given(seed=st.integers(0, 100_000))
    @settings(max_examples=20, deadline=None)
    def test_refresh_interleaved_with_selection(self, seed):
        rng = np.random.default_rng(seed)
        sites, links = _grid(rng, 24)
        w = _weights(rng)
        tiers = _skewed_tiers(rng, list(sites), 4)
        sp, jp, pw = _port(sites, links, _jobs(rng, 15), w)
        tp = P.TierPack.from_site_pack(sp, tiers)
        P.hier_select(jp, sp, tp, pw)
        dirty = rng.choice(24, size=5, replace=False)
        for c in dirty:
            sp.bw[c] = float(rng.uniform(1e6, 1e10))
            sp.loss[c] = float(rng.uniform(0, 0.05))
        tp.refresh(sp, np.asarray(dirty, np.int64))
        flat = PB.batched_argmin(PB.batched_cost_matrix(jp, sp, pw), sp)
        hier = P.hier_select(jp, sp, tp, pw)
        assert hier.sites == flat.sites and hier.costs.tolist() == flat.costs.tolist()


class TestPortEqualsReference:
    """TierPack, hier_select, hier_replay and the scheduler's mode="hier"
    against the reference on the same state."""

    @given(seed=st.integers(0, 100_000), n_sites=st.integers(2, 48),
           n_tiers=st.integers(1, 7), n_jobs=st.integers(1, 30))
    @settings(max_examples=30, deadline=None)
    def test_select_and_replay(self, seed, n_sites, n_tiers, n_jobs):
        rng = np.random.default_rng(seed)
        sites, links = _grid(rng, n_sites)
        w = _weights(rng)
        tiers = _skewed_tiers(rng, list(sites), n_tiers)
        jobs = _jobs(rng, n_jobs)
        rsp = RB.SitePack.from_scheduler(sites, links)
        rtp = RB.TierPack.from_site_pack(rsp, tiers)
        sp, jp, pw = _port(sites, links, jobs, w)
        tp = P.TierPack.from_site_pack(sp, tiers)
        assert tp.labels == rtp.labels
        assert tp.tier_of.tolist() == rtp.tier_of.tolist()
        assert [m.tolist() for m in tp.members] == [m.tolist() for m in rtp.members]
        for f in TIER_FIELDS:
            np.testing.assert_array_equal(getattr(tp, f).numpy(), getattr(rtp, f), err_msg=f)
        _same(P.hier_select(jp, sp, tp, pw), RB.hier_select(RB.JobPack.from_jobs(jobs), rsp, rtp, w))
        got = P.hier_replay(jp, sp, tp, pw)
        _same(got, RB.hier_replay(RB.JobPack.from_jobs(jobs), rsp, rtp, w))
        np.testing.assert_array_equal(sp.queue.numpy(), rsp.queue)
        np.testing.assert_array_equal(sp.work.numpy(), rsp.work)

    @pytest.mark.parametrize("seed", range(4))
    def test_scheduler_mode_hier_with_topology(self, seed):
        rng = np.random.default_rng(seed)
        sites, links = _grid(rng, 40, dead_fraction=0.15)
        names = sorted(sites)
        topos = []
        for mod in (R, P):
            topo = mod.GridTopology()
            for i, n in enumerate(names):
                topo.join(f"root{i % 5}", mod.Node(name=n))
            topos.append(topo)
        jobs = _jobs(rng, 50)
        st_ = P.state_from_reference(sites, links, jobs)
        ref = R.DianaScheduler(copy.deepcopy(sites), dict(links), topology=topos[0])
        port = P.DianaScheduler(copy.deepcopy(st_.sites), dict(st_.links), topology=topos[1],
                                device=CPU)
        _same(port.select_sites_batch(copy.deepcopy(st_.jobs), mode="hier"),
              ref.select_sites_batch(copy.deepcopy(jobs), mode="hier"))
        _same(port.place_batch(copy.deepcopy(st_.jobs), mode="hier"),
              ref.place_batch(copy.deepcopy(jobs), mode="hier"))
        for n in names:
            assert (port.sites[n].queue_length, port.sites[n].waiting_work) == \
                (ref.sites[n].queue_length, ref.sites[n].waiting_work)

    def test_degenerate_links_and_weights(self):
        """NaN and zero bandwidths, negative weights (the f32 gate off),
        a dead tier: the same answers as the reference."""
        rng = np.random.default_rng(21)
        sites, links = _grid(rng, 30)
        names = list(sites)
        links[names[1]] = R.NetworkLink(bandwidth_Bps=0.0, loss_rate=0.0)
        links[names[2]] = R.NetworkLink(bandwidth_Bps=float("nan"), loss_rate=0.01)
        for n in names[5:9]:
            sites[n].alive = False
        tiers = {n: ("dead" if 5 <= i < 9 else f"t{i % 3}") for i, n in enumerate(names)}
        jobs = _jobs(rng, 40)
        for w in (R.CostWeights(), R.CostWeights(w_queue=-0.5, w_work=1.0, w_load=0.3)):
            rsp = RB.SitePack.from_scheduler(sites, links)
            rtp = RB.TierPack.from_site_pack(rsp, tiers)
            sp, jp, pw = _port(sites, links, jobs, w)
            tp = P.TierPack.from_site_pack(sp, tiers)
            assert PB._f32_gate(jp, sp, tp, pw) == RB._f32_gate(RB.JobPack.from_jobs(jobs), rsp, rtp, w)
            _same(P.hier_select(jp, sp, tp, pw), RB.hier_select(RB.JobPack.from_jobs(jobs), rsp, rtp, w))
            _same(P.hier_replay(jp, sp, tp, pw), RB.hier_replay(RB.JobPack.from_jobs(jobs), rsp, rtp, w))


class TestLazyMigration:
    @given(seed=st.integers(0, 100_000), n_jobs=st.integers(1, 25), n_peers=st.integers(1, 20))
    @settings(max_examples=40, deadline=None)
    def test_lazy_targets_match_dense(self, seed, n_jobs, n_peers):
        rng = np.random.default_rng(seed)
        cost = rng.uniform(0, 100, (n_jobs, n_peers))
        cost[rng.uniform(size=cost.shape) < 0.1] = np.inf
        ja = rng.integers(0, 6, (n_jobs, n_peers)).astype(float)
        lcost = rng.uniform(0, 100, n_jobs)
        lja = rng.integers(0, 6, n_jobs).astype(float)
        pinned = rng.uniform(size=n_jobs) < 0.2
        excluded = rng.uniform(size=n_peers) < 0.3
        touched = torch.zeros(n_peers, dtype=torch.bool)
        cost_t = torch.as_tensor(cost)

        def cost_cols(cols):
            touched[cols] = True
            return cost_t[:, cols]

        args = [torch.as_tensor(x) for x in (pinned, lja, lcost, excluded)]
        m1, b1 = PM.select_peer_targets(*args, torch.as_tensor(ja), cost_t)
        m2, b2, bc = PM.select_peer_targets_lazy(*args, torch.as_tensor(ja), cost_cols)
        rm, rb = RM.select_peer_targets(pinned, lja, lcost, excluded, ja, cost)
        assert m1.tolist() == m2.tolist() == rm.tolist()
        if excluded.all():
            return
        assert b1.tolist() == b2.tolist() == rb.tolist()
        rows = torch.arange(n_jobs)
        assert torch.equal(bc[m2], cost_t[rows, b2][m2])
        ja_m = np.where(excluded[None, :], np.inf, ja)
        cand = (ja_m == ja_m.min(axis=1)[:, None]).any(axis=0)
        assert not touched[torch.as_tensor(~cand)].any()

    @given(seed=st.integers(0, 100_000), n_jobs=st.integers(0, 20))
    @settings(max_examples=25, deadline=None)
    def test_select_peers_batch_lazy_reasons_match(self, seed, n_jobs):
        rng = np.random.default_rng(seed)
        n_peers = int(rng.integers(1, 12))
        names = [f"p{i}" for i in range(n_peers)]
        local = names[int(rng.integers(0, n_peers))]
        cost = rng.uniform(0, 50, (n_jobs, n_peers))
        ja = rng.integers(0, 4, (n_jobs, n_peers)).astype(float)
        lcost = rng.uniform(0, 50, n_jobs)
        lja = rng.integers(0, 4, n_jobs).astype(float)
        alive = rng.uniform(size=n_peers) > 0.25
        jobs = [R.Job(user="u", migrated=bool(rng.uniform() < 0.2)) for _ in range(n_jobs)]
        pjobs = P.state_from_reference({}, {}, jobs).jobs
        key = lambda ds: [(d.migrate, d.target, d.reason) for d in ds]  # noqa: E731
        ref = R.select_peers_batch(jobs, local, lja, lcost, names, ja, cost, alive=alive)
        dense = P.select_peers_batch(pjobs, local, lja, lcost, names, torch.as_tensor(ja),
                                     torch.as_tensor(cost), alive=alive)
        lazy = P.select_peers_batch(pjobs, local, lja, lcost, names, torch.as_tensor(ja),
                                    alive=alive, cost_cols=lambda c: torch.as_tensor(cost)[:, c])
        assert key(dense) == key(lazy) == key(ref)
