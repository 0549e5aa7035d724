"""§IX migration, ported: ``repro_torch.core.migration`` on the host must
decide what ``repro.core.migration`` decides — targets, migrate masks,
best costs and reason strings — on the reference's own tests
(tests/core/test_migration.py), its corners and a 10k × 256 plane."""
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.migration as RM
import repro_torch.core as P
import repro_torch.core.migration as PM


def _peers(mod, **jobs_ahead):
    return [
        mod.PeerView(name=k, queue_length=v, jobs_ahead=v, total_cost=float(v))
        for k, v in jobs_ahead.items()
    ]


def _same_decision(a, b):
    assert (a.migrate, a.target, a.reason) == (b.migrate, b.target, b.reason)


class TestSelectPeer:
    """The scalar §IX rule, on both packages, case for case."""

    @pytest.mark.parametrize("local_ja,local_cost,peers", [
        (10, 5.0, dict(a=7, b=2, c=9)),      # migrates to least loaded
        (1, 0.1, dict(a=7, b=2)),            # local is best
        (10, 5.0, dict(b=1)),
        (3, 0.0, dict(a=1, b=1)),            # fewer ahead, not cheaper
    ])
    def test_matches_reference(self, local_ja, local_cost, peers):
        d_ref = R.select_peer(R.Job(user="u", priority=-0.7), "local", local_ja, local_cost,
                              _peers(R, **peers))
        d_port = P.select_peer(P.Job(user="u", priority=-0.7), "local", local_ja, local_cost,
                               _peers(P, **peers))
        _same_decision(d_port, d_ref)

    def test_migrates_to_least_loaded(self):
        d = P.select_peer(P.Job(user="u", priority=-0.7), "local", 10, 5.0, _peers(P, a=7, b=2, c=9))
        assert d.migrate and d.target == "b"

    def test_pinned_after_one_migration(self):
        job = P.Job(user="u", priority=-0.7)
        d = P.select_peer(job, "local", 10, 5.0, _peers(P, b=1))
        PM.apply_migration(job, d)
        assert job.migrated and job.site == "b"
        d2 = P.select_peer(job, "b", 10, 5.0, _peers(P, c=0))
        assert not d2.migrate and "pinned" in d2.reason

    def test_priority_bumped_on_migration(self):
        jr, jp = R.Job(user="u", priority=-0.7), P.Job(user="u", priority=-0.7)
        RM.apply_migration(jr, R.select_peer(jr, "local", 10, 5.0, _peers(R, b=1)))
        PM.apply_migration(jp, P.select_peer(jp, "local", 10, 5.0, _peers(P, b=1)))
        assert jp.priority == jr.priority == pytest.approx(-0.6)

    def test_dead_peers_ignored(self):
        peers = [P.PeerView(name="dead", queue_length=0, jobs_ahead=0, total_cost=0.0, alive=False)]
        d = P.select_peer(P.Job(user="u", priority=-0.7), "local", 10, 5.0, peers)
        assert not d.migrate and d.reason == "no alive peers"


class TestCongestionMigration:
    @staticmethod
    def _congested_queue(mod):
        q = mod.MultilevelFeedbackQueues(quotas={"u": 10.0, "v": 1000.0}, congestion_thrs=0.5)
        for i in range(2):
            q.submit(mod.Job(user="v", t=1, submit_time=float(i)), now=float(i))
        for i in range(2, 22):
            q.submit(mod.Job(user="u", t=1, submit_time=float(i)), now=float(i))
        return q

    @pytest.mark.parametrize("max_moves", [None, 2])
    def test_moves_match_reference(self, max_moves):
        out = []
        for mod in (R, P):
            q = self._congested_queue(mod)
            q4 = {id(j) for j in q.low_priority_jobs()}
            moved = mod.migrate_congested(
                q, "local", poll_peers=lambda j, mod=mod: _peers(mod, remote=0),
                local_cost=lambda j: 100.0, window=30.0, now=20.0, max_moves=max_moves,
            )
            assert moved and all(id(j) in q4 and j.migrated for j, _ in moved)
            out.append([(j.user, j.submit_time, j.priority, t) for j, t in moved])
        assert out[0] == out[1]
        if max_moves is not None:
            assert len(out[1]) <= max_moves

    def test_no_migration_without_congestion(self):
        q = P.MultilevelFeedbackQueues(quotas={"u": 10.0}, congestion_thrs=0.5)
        for i in range(4):
            q.submit(P.Job(user="u", t=1, submit_time=float(i)), now=float(i))
            q.pop_next(now=float(i) + 0.5)
        moved = P.migrate_congested(q, "local", poll_peers=lambda j: _peers(P, remote=0),
                                    local_cost=lambda j: 100.0, window=10.0, now=4.0)
        assert moved == []


def _port_jobs(jobs):
    return P.state_from_reference({}, {}, jobs).jobs


def _both_batch(jobs, local, lja, lcost, names, ja, cost, **kw):
    """select_peers_batch of both packages on the same inputs; the
    port's gets tensors, the reference's NumPy arrays."""
    ref = R.select_peers_batch(jobs, local, lja, lcost, names, ja, cost, **kw)
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    port = P.select_peers_batch(_port_jobs(jobs), local, torch.as_tensor(np.asarray(lja, float)),
                                torch.as_tensor(np.asarray(lcost, float)), names,
                                torch.as_tensor(ja), torch.as_tensor(cost), **tkw)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        _same_decision(a, b)
    return port


class TestSelectPeersBatch:
    """The vectorized rule replicates select_peer row by row (as in the
    reference's suite) and the reference's batch path exactly."""

    def _assert_rows_match(self, jobs, local, lja, lcost, names, ja, cost, alive=None):
        batch = _both_batch(jobs, local, lja, lcost, names, ja, cost, alive=alive)
        for r, job in enumerate(_port_jobs(jobs)):
            peers = [
                P.PeerView(name=n, queue_length=int(ja[r][s]), jobs_ahead=int(ja[r][s]),
                           total_cost=cost[r][s],
                           alive=bool(alive[s]) if alive is not None else True)
                for s, n in enumerate(names)
            ]
            _same_decision(batch[r], P.select_peer(job, local, lja[r], lcost[r], peers))

    def test_jobs_ahead_tie_broken_by_cost(self):
        self._assert_rows_match([R.Job(user="u")], "local", [9], [10.0], ["a", "b", "c"],
                                np.asarray([[2, 2, 5]], float), np.asarray([[3.0, 1.0, 0.5]]))

    def test_full_tie_keeps_first_peer_in_order(self):
        self._assert_rows_match([R.Job(user="u")], "local", [5], [9.0], ["z", "m", "a"],
                                np.asarray([[1, 1, 1]], float), np.asarray([[2.0, 2.0, 2.0]]))

    def test_local_column_excluded(self):
        self._assert_rows_match([R.Job(user="u")], "local", [4], [5.0], ["local", "b"],
                                np.asarray([[0, 3]], float), np.asarray([[0.0, 1.0]]))

    def test_pinned_and_no_peer_reasons(self):
        ja, cost = np.asarray([[1], [1]], float), np.asarray([[1.0], [1.0]])
        jobs = [R.Job(user="u", migrated=True), R.Job(user="v")]
        self._assert_rows_match(jobs, "local", [5, 5], [9.0, 9.0], ["a"], ja, cost)
        self._assert_rows_match(jobs, "local", [5, 5], [9.0, 9.0], ["a"], ja, cost,
                                alive=np.asarray([False]))

    def test_fuzz_matches_select_peer(self):
        rng = np.random.default_rng(0)
        names = [f"p{i}" for i in range(6)]
        for _ in range(50):
            J = int(rng.integers(1, 8))
            ja = rng.integers(0, 4, size=(J, 6)).astype(float)
            cost = rng.integers(0, 3, size=(J, 6)).astype(float)
            alive = rng.uniform(size=6) > 0.2
            jobs = [R.Job(user="u", migrated=bool(rng.uniform() < 0.2)) for _ in range(J)]
            lja = rng.integers(0, 5, size=J)
            lcost = rng.integers(0, 3, size=J).astype(float)
            self._assert_rows_match(jobs, "p0", lja, lcost, names, ja, cost, alive=alive)

    def test_stale_columns_are_not_trusted(self):
        names = ["stale", "fresh"]
        ja, cost = np.asarray([[0.0, 2.0]]), np.asarray([[0.5, 1.0]])
        jobs = [R.Job(user="u")]
        d = _both_batch(jobs, "local", [9], [5.0], names, ja, cost,
                        staleness=np.asarray([900.0, 10.0]), max_staleness=60.0)
        assert d[0].migrate and d[0].target == "fresh"
        d = _both_batch(jobs, "local", [9], [5.0], names, ja, cost,
                        staleness=np.asarray([900.0, 900.0]), max_staleness=60.0)
        assert d[0].reason == "no sufficiently fresh peers"
        d = _both_batch(jobs, "local", [9], [5.0], names, ja, cost,
                        alive=np.asarray([False, False]), staleness=np.asarray([900.0, 900.0]),
                        max_staleness=60.0)
        assert d[0].reason == "no alive peers"
        migrate, best = PM.select_peer_targets(
            torch.tensor([False]), torch.tensor([9.0]), torch.tensor([5.0]),
            torch.zeros(2, dtype=torch.bool), torch.as_tensor(ja), torch.as_tensor(cost),
            staleness=torch.tensor([900.0, 10.0]), max_staleness=60.0)
        assert migrate.tolist() == [True] and best.tolist() == [1]

    def test_targets_agree_with_decisions(self):
        rng = np.random.default_rng(1)
        names = [f"p{i}" for i in range(5)]
        ja = rng.integers(0, 4, size=(10, 5)).astype(float)
        cost = rng.integers(0, 3, size=(10, 5)).astype(float)
        jobs = [R.Job(user="u", migrated=bool(rng.uniform() < 0.2)) for _ in range(10)]
        lja = rng.integers(0, 5, size=10)
        lcost = rng.integers(0, 3, size=10).astype(float)
        decisions = _both_batch(jobs, "p2", lja, lcost, names, ja, cost)
        pinned = np.asarray([j.migrated for j in jobs])
        excluded = np.asarray([n == "p2" for n in names])
        migrate, best = PM.select_peer_targets(pinned, lja, lcost, excluded, ja, cost,
                                               device="cpu")
        for r, d in enumerate(decisions):
            assert d.migrate == bool(migrate[r])
            if d.migrate:
                assert d.target == names[int(best[r])]


def _targets_both(pinned, lja, lcost, excluded, ja, cost, **kw):
    m_ref, b_ref = RM.select_peer_targets(pinned, lja, lcost, excluded, ja, cost, **kw)
    m, b = PM.select_peer_targets(*(torch.as_tensor(np.asarray(x)) for x in
                                    (pinned, lja, lcost, excluded, ja, cost)), **kw)
    assert m.dtype == torch.bool and b.dtype == torch.int64
    assert m.tolist() == m_ref.tolist() and b.tolist() == b_ref.tolist()
    return m, b


def _lazy_both(pinned, lja, lcost, excluded, ja, cost):
    calls = []

    def cols_np(c):
        return cost[:, c]

    def cols_t(c):
        calls.append(c.tolist())
        return torch.as_tensor(cost)[:, c]

    m_ref, b_ref, c_ref = RM.select_peer_targets_lazy(pinned, lja, lcost, excluded, ja, cols_np)
    m, b, c = PM.select_peer_targets_lazy(*(torch.as_tensor(np.asarray(x)) for x in
                                            (pinned, lja, lcost, excluded, ja)), cols_t)
    assert m.tolist() == m_ref.tolist() and b.tolist() == b_ref.tolist()
    np.testing.assert_array_equal(c.numpy(), c_ref)
    assert len(calls) <= 1
    return m, b, c


def _plane(rng, J, S, ja_hi=4, cost_hi=3, p_nan=0.0, p_inf=0.0):
    ja = rng.integers(0, ja_hi, size=(J, S)).astype(float)
    cost = rng.integers(0, cost_hi, size=(J, S)).astype(float)
    cost[rng.uniform(size=(J, S)) < p_inf] = np.inf
    cost[rng.uniform(size=(J, S)) < p_nan] = np.nan
    return ja, cost


class TestCorners:
    """The reference's corners, one by one."""

    def test_all_inf_row_falls_back_to_first_candidate(self):
        ja = np.asarray([[3.0, 1.0, 1.0, 2.0]])
        cost = np.full((1, 4), np.inf)
        m, b = _targets_both([False], [5.0], [np.inf], np.zeros(4, bool), ja, cost)
        assert b.tolist() == [1]
        _lazy_both([False], [5.0], [np.inf], np.zeros(4, bool), ja, cost)

    @pytest.mark.parametrize("seed", range(8))
    def test_nan_costs_and_jobs_ahead(self, seed):
        rng = np.random.default_rng(seed)
        ja, cost = _plane(rng, 12, 7, p_nan=0.15, p_inf=0.15)
        ja[rng.uniform(size=ja.shape) < 0.05] = np.nan
        lcost = rng.choice([0.0, 1.0, np.inf, np.nan], size=12)
        lja = rng.integers(0, 5, size=12).astype(float)
        pinned = rng.uniform(size=12) < 0.2
        excluded = rng.uniform(size=7) < 0.3
        if excluded.all():
            excluded[0] = False
        _targets_both(pinned, lja, lcost, excluded, ja, cost)
        _lazy_both(pinned, lja, lcost, excluded, ja, cost)

    def test_empty_and_degenerate_shapes(self):
        empty = np.zeros((0, 2))
        for plane in (empty, np.asarray([])):
            m, b = PM.select_peer_targets(np.zeros(0, bool), np.zeros(0), np.zeros(0),
                                          np.zeros(2, bool), plane, plane, device="cpu")
            assert m.shape == (0,) and b.shape == (0,)
            assert P.select_peers_batch([], "local", np.zeros(0), np.zeros(0), ["a", "b"],
                                        plane, plane, device="cpu") == []
            m, b, c = PM.select_peer_targets_lazy(np.zeros(0, bool), np.zeros(0), np.zeros(0),
                                                  np.zeros(2, bool), plane, lambda c: plane,
                                                  device="cpu")
            assert m.shape == b.shape == c.shape == (0,)
        # jobs but no peers: (J, 0) planes give J no-migrate rows
        m, b = _targets_both(np.zeros(3, bool), np.zeros(3), np.zeros(3), np.zeros(0, bool),
                             np.zeros((3, 0)), np.zeros((3, 0)))
        assert m.shape == (3,) and not m.any()
        m, b, c = _lazy_both(np.zeros(3, bool), np.zeros(3), np.zeros(3), np.zeros(0, bool),
                             np.zeros((3, 0)), np.zeros((3, 0)))
        assert c.tolist() == [np.inf] * 3
        d = _both_batch([R.Job(user="u") for _ in range(3)], "local", np.zeros(3), np.zeros(3),
                        [], np.zeros((3, 0)), np.zeros((3, 0)))
        assert [x.reason for x in d] == ["no alive peers"] * 3

    def test_non_empty_1d_plane_raises(self):
        with pytest.raises(ValueError, match="plane"):
            PM.select_peer_targets(np.zeros(1, bool), np.zeros(1), np.zeros(1),
                                   np.zeros(2, bool), np.zeros(2), np.zeros(2), device="cpu")
        with pytest.raises(ValueError, match="plane"):
            PM.select_peer_targets_lazy(np.zeros(1, bool), np.zeros(1), np.zeros(1),
                                        np.zeros(2, bool), np.zeros(2), lambda c: None,
                                        device="cpu")
        with pytest.raises(ValueError, match="plane"):
            P.select_peers_batch([P.Job(user="u")], "local", [9], [5.0], ["a", "b"],
                                 np.zeros(2), np.zeros(2), device="cpu")

    def test_every_column_excluded(self):
        ja, cost = np.ones((2, 3)), np.ones((2, 3))
        m, b = _targets_both(np.zeros(2, bool), [5.0, 5.0], [9.0, 9.0], np.ones(3, bool), ja, cost)
        assert not m.any() and b.tolist() == [0, 0]

    @pytest.mark.parametrize("seed", range(20))
    def test_dense_equals_lazy(self, seed):
        rng = np.random.default_rng(100 + seed)
        J, S = int(rng.integers(1, 30)), int(rng.integers(1, 12))
        ja, cost = _plane(rng, J, S, p_inf=0.1 * (seed % 3), p_nan=0.05 * (seed % 2))
        pinned = rng.uniform(size=J) < 0.2
        lja = rng.integers(0, 5, size=J).astype(float)
        lcost = rng.integers(0, 3, size=J).astype(float)
        excluded = rng.uniform(size=S) < 0.3
        m, b = _targets_both(pinned, lja, lcost, excluded, ja, cost)
        ml, bl, _ = _lazy_both(pinned, lja, lcost, excluded, ja, cost)
        assert ml.tolist() == m.tolist() and bl.tolist() == b.tolist()
        d = _both_batch([R.Job(user="u", migrated=bool(p)) for p in pinned], "p0", lja, lcost,
                        [f"p{i}" for i in range(S)], ja, cost)
        dl = P.select_peers_batch(_port_jobs([R.Job(user="u", migrated=bool(p)) for p in pinned]),
                                  "p0", lja, lcost, [f"p{i}" for i in range(S)],
                                  torch.as_tensor(ja), cost_cols=lambda c: torch.as_tensor(cost)[:, c])
        for x, y in zip(d, dl):
            _same_decision(x, y)


class TestReductions:
    """first_min_index / first_true_index are np.argmin / np.argmax."""

    @pytest.mark.parametrize("seed", range(6))
    def test_first_min_index_is_np_argmin(self, seed):
        rng = np.random.default_rng(seed)
        x = rng.choice([0.0, 1.0, -1.0, np.inf, -np.inf, np.nan], size=(200, 9),
                       p=[0.3, 0.2, 0.2, 0.1, 0.1, 0.1])
        assert PM.first_min_index(torch.as_tensor(x)).tolist() == np.argmin(x, axis=1).tolist()
        m = rng.uniform(size=(200, 9)) < 0.2
        assert PM.first_true_index(torch.as_tensor(m)).tolist() == np.argmax(m, axis=1).tolist()


class TestBenchScalePlane:
    """A seeded 10,000 × 256 candidate plane with forced ties: small
    integer jobs-ahead and cost ranges, dead and local columns."""

    def test_targets_match_reference(self):
        rng = np.random.default_rng(0)
        J, S = 10_000, 256
        ja, cost = _plane(rng, J, S, ja_hi=3, cost_hi=4, p_inf=0.02)
        lja = rng.integers(0, 4, size=J).astype(float)
        lcost = rng.integers(0, 4, size=J).astype(float)
        pinned = rng.uniform(size=J) < 0.1
        excluded = rng.uniform(size=S) < 0.05
        excluded[17] = True
        m, b = _targets_both(pinned, lja, lcost, excluded, ja, cost)
        assert 0 < int(m.sum()) < J
        ml, bl, _ = _lazy_both(pinned, lja, lcost, excluded, ja, cost)
        assert ml.tolist() == m.tolist() and bl.tolist() == b.tolist()
