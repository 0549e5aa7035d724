"""The port's §X priorities and multilevel feedback queues against the
reference: the float32 vector form against the Pallas kernel in
interpret mode (rtol 1e-6, identical bands), the host float64 twin bit
for bit, and the queue manager decision for decision."""
import numpy as np
import pytest
import torch

from repro.core import Job as RJob, MultilevelFeedbackQueues as RMLFQ, is_congested as r_is_congested
from repro.core import priority as rprio
from repro.kernels.priority_requeue.ops import priority_requeue as jax_priority_requeue

from repro_torch.core import Job as PJob, MultilevelFeedbackQueues as PMLFQ, is_congested as p_is_congested
from repro_torch.core import priority as pprio
from repro_torch.kernels.priority_requeue.ops import priority_requeue
from repro_torch.kernels.priority_requeue.ref import priority_requeue_ref

CPU = "cpu"


def _queue_inputs(L, seed=None):
    """tests/kernels/test_kernels.py:17's draws."""
    rng = np.random.default_rng(L if seed is None else seed)
    n = rng.integers(1, 50, L).astype(np.float32)
    q = rng.uniform(10, 5000, L).astype(np.float32)
    t = rng.uniform(1, 64, L).astype(np.float32)
    return n, q, t, float(q.sum()), float(t.sum())


class TestReprioritizeAgainstPallas:
    @pytest.mark.parametrize("L", [1, 37, 128, 8192, 10_000])
    def test_matches_kernel(self, L):
        n, q, t, Q, T = _queue_inputs(L)
        pr_k, qi_k = jax_priority_requeue(n, q, t, Q, T, use_kernel=True, interpret=True)
        pr, qi = pprio.reprioritize(n, q, t, Q, T, device=CPU)
        assert pr.dtype == torch.float32 and qi.dtype == torch.int32
        np.testing.assert_allclose(pr.numpy(), np.asarray(pr_k), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(qi.numpy(), np.asarray(qi_k))

    @pytest.mark.parametrize("L", [1, 37, 10_000])
    def test_matches_jnp_reprioritize(self, L):
        n, q, t, Q, T = _queue_inputs(L, seed=L + 1)
        pr_r, qi_r = rprio.reprioritize(n, q, t, Q, T)
        pr, qi = pprio.reprioritize(n, q, t, Q, T, device=CPU)
        np.testing.assert_allclose(pr.numpy(), np.asarray(pr_r), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(qi.numpy(), np.asarray(qi_r))
        np.testing.assert_array_equal(pprio.queue_index_vec(pr).numpy(), qi.numpy())

    def test_fig6_triple(self):
        n = np.array([2, 2, 1], np.float32)
        q = np.array([1900, 1900, 1700], np.float32)
        t = np.array([1, 5, 1], np.float32)
        pr, qi = pprio.reprioritize(n, q, t, 3600.0, 7.0, device=CPU)
        np.testing.assert_allclose(pr.numpy(), [0.4586, -0.6305, 0.6974], atol=1e-4)
        assert qi.tolist() == [1, 3, 0]
        pr_k, _ = jax_priority_requeue(n, q, t, 3600.0, 7.0, use_kernel=True, interpret=True)
        np.testing.assert_allclose(pr.numpy(), np.asarray(pr_k), rtol=1e-6)

    def test_empty_queue(self):
        pr, qi = pprio.reprioritize([], [], [], 1.0, 1.0, device=CPU)
        assert pr.shape == qi.shape == (0,)


class TestHostTwinBitIdentical:
    @pytest.mark.parametrize("L", [1, 37, 4096])
    def test_reprioritize_np(self, L):
        n, q, t, Q, T = _queue_inputs(L, seed=3 * L)
        pr_r, qi_r = rprio.reprioritize_np(n, q, t, Q, T)
        pr, qi = pprio.reprioritize_np(n, q, t, Q, T)
        assert np.array_equal(pr, pr_r) and np.array_equal(qi, qi_r)
        assert qi.dtype == np.int32

    @pytest.mark.parametrize("L", [1, 37, 4096])
    def test_float64_plain_version_equals_twin(self, L):
        """The f64 instance of the kernel (its plain version here) is held
        bit-identical to the host twin."""
        n, q, t, Q, T = _queue_inputs(L, seed=5 * L)
        f64 = lambda a: torch.from_numpy(a.astype(np.float64))  # noqa: E731
        pr, qi = priority_requeue(f64(n), f64(q), f64(t), Q, T)
        pr_np, qi_np = rprio.reprioritize_np(n, q, t, Q, T)
        assert np.array_equal(pr.numpy(), pr_np) and np.array_equal(qi.numpy(), qi_np)
        pr_ref, qi_ref = priority_requeue_ref(f64(n), f64(q), f64(t), Q, T)
        assert torch.equal(pr, pr_ref) and torch.equal(qi, qi_ref)


class TestScalarPriority:
    @pytest.mark.parametrize("seed", range(5))
    def test_scalar_terms_match(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(50):
            q, t = float(rng.uniform(1, 1e4)), float(rng.uniform(0.5, 64))
            Q, T = q + float(rng.uniform(0, 1e4)), t + float(rng.uniform(0, 1e3))
            n = int(rng.integers(1, 100))
            N = pprio.threshold(q, Q, t, T)
            assert N == rprio.threshold(q, Q, t, T)
            p = pprio.priority(n, N)
            assert p == rprio.priority(n, N)
            assert pprio.queue_index(p) == rprio.queue_index(p)

    def test_fig6_walkthrough_numbers(self):
        assert pprio.threshold(q=1900, Q=1900, t=1, T=1) == 1.0
        assert pprio.priority(n=2, N=pprio.threshold(q=1900, Q=1900, t=5, T=6)) == pytest.approx(-0.4)
        p = pprio.priority(n=1, N=pprio.threshold(q=1700, Q=3600, t=1, T=7))
        assert p == pytest.approx(0.6974, abs=1e-4) and pprio.queue_index(p) == 0

    def test_rejects_nonpositive(self):
        with pytest.raises(ValueError):
            pprio.threshold(q=0, Q=1, t=1, T=1)
        with pytest.raises(ValueError):
            pprio.priority(n=0, N=1.0)

    def test_constants(self):
        assert pprio.NUM_QUEUES == rprio.NUM_QUEUES
        assert pprio.QUEUE_BOUNDS == rprio.QUEUE_BOUNDS
        assert pprio.littles_law_queue_length(2.5, 4.0) == rprio.littles_law_queue_length(2.5, 4.0)


def _twin_queues(quotas, thrs=0.5):
    return RMLFQ(quotas=dict(quotas), congestion_thrs=thrs), PMLFQ(quotas=dict(quotas), congestion_thrs=thrs)


def _state(mlfq):
    return [(j.user, j.t, j.submit_time, j.priority, j.queue) for j in mlfq.jobs]


class TestQueuesMirror:
    """tests/core/test_queues.py, run through both packages side by side."""

    def test_fig6_walkthrough(self):
        r, p = _twin_queues({"A": 1900.0, "B": 1700.0})
        for user, t, ts in (("A", 1, 0.0), ("A", 5, 1.0), ("B", 1, 2.0)):
            r.submit(RJob(user=user, t=t, submit_time=ts))
            p.submit(PJob(user=user, t=t, submit_time=ts))
            assert _state(p) == _state(r)
        assert [j.queue for j in p.jobs] == [1, 3, 0]
        assert [j.priority for j in p.jobs] == pytest.approx([0.4586, -0.6305, 0.6974], abs=1e-4)
        order_r = [r.pop_next().user for _ in range(3)]
        order_p = [p.pop_next() for _ in range(3)]
        assert [j.user for j in order_p] == order_r == ["B", "A", "A"]
        assert [j.t for j in order_p] == [1, 1, 5]
        assert p.pop_next() is None

    @pytest.mark.parametrize("seed", range(6))
    def test_random_arrivals_same_priorities_bands_and_pops(self, seed):
        rng = np.random.default_rng(seed)
        quotas = {"u1": 100.0, "u2": 200.0, "u3": 300.0}
        r, p = _twin_queues(quotas)
        for i in range(int(rng.integers(1, 40))):
            user = str(rng.choice(["u1", "u2", "u3", "u4"]))
            t = float(rng.integers(1, 16))
            r.submit(RJob(user=user, t=t, submit_time=float(i)), now=float(i))
            p.submit(PJob(user=user, t=t, submit_time=float(i)), now=float(i))
            assert _state(p) == _state(r)
            assert p.quotas == r.quotas
        assert [[j.t for j in b] for b in p.queue_contents()] == [[j.t for j in b] for b in r.queue_contents()]
        assert [j.t for j in p.low_priority_jobs()] == [j.t for j in r.low_priority_jobs()]
        for lvl in (0.9, 0.3, 0.0, -0.7):
            assert p.jobs_ahead(lvl) == r.jobs_ahead(lvl)
        now = 100.0
        while len(r):
            a, b = r.pop_next(now=now), p.pop_next(now=now)
            assert (b.user, b.t, b.submit_time, b.priority) == (a.user, a.t, a.submit_time, a.priority)
            now += float(rng.uniform(0, 2))
        assert p.pop_next() is None and len(p) == 0

    def test_fcfs_and_sjf(self):
        r, p = _twin_queues({"A": 100.0, "B": 100.0})
        for m, J in ((r, RJob), (p, PJob)):
            m.submit(J(user="A", t=2, submit_time=0.0))
            m.submit(J(user="B", t=2, submit_time=5.0))
        assert p.pop_next().submit_time == r.pop_next().submit_time == 0.0
        r, p = _twin_queues({"A": 100.0})
        r.submit_batch([RJob(user="A", t=t) for t in (8, 1, 4, 2)])
        p.submit_batch([PJob(user="A", t=t) for t in (8, 1, 4, 2)])
        assert [p.pop_next().t for _ in range(4)] == [r.pop_next().t for _ in range(4)] == [1, 2, 4, 8]

    def test_service_does_not_reprioritize(self):
        _, p = _twin_queues({"A": 100.0, "B": 50.0})
        p.submit(PJob(user="A", t=1))
        p.submit(PJob(user="B", t=1))
        before = {j.job_id: j.priority for j in p.jobs}
        p.pop_next()
        assert all(before[j.job_id] == j.priority for j in p.jobs)

    def test_rates_congestion_and_littles_law(self):
        rng = np.random.default_rng(9)
        r, p = _twin_queues({"u": 100.0}, thrs=0.3)
        now = 0.0
        for k in range(300):
            now += float(rng.exponential(1.0))
            r.submit(RJob(user="u", submit_time=now), now=now)
            p.submit(PJob(user="u", submit_time=now), now=now)
            if k % 3 == 0:
                r.pop_next(now=now)
                p.pop_next(now=now)
            for window in (5.0, 20.0):
                assert p.rates(window, now) == r.rates(window, now)
                assert p.congested(window, now) == r.congested(window, now)
                assert p.littles_law_estimate(window, now, 2.0) == r.littles_law_estimate(window, now, 2.0)

    @pytest.mark.parametrize("a,s,thrs", [(10.0, 2.0, 0.5), (10.0, 8.0, 0.5), (0.0, 5.0, 0.5), (3.0, 0.0, 0.99)])
    def test_is_congested(self, a, s, thrs):
        assert p_is_congested(a, s, thrs) == r_is_congested(a, s, thrs)

    def test_job_properties(self):
        for kw in (dict(compute_work=5.0, input_bytes=2.0), dict(compute_work=1.0, input_bytes=3.0, output_bytes=4.0)):
            a, b = RJob(user="u", **kw), PJob(user="u", **kw)
            assert (b.total_bytes, b.data_intensive) == (a.total_bytes, a.data_intensive)
