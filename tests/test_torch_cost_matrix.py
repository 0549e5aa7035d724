"""The port's §IV cost plane against the reference.

Float32: the port's ``cost_matrix_classed`` against the Pallas kernel
run in interpret mode, at the JAX kernel suite's own tolerance
(rtol 1e-5, identical argmin). Float64: the port's exact plane and
fused argmin against the reference's NumPy path, bit for bit. On the
host the port's wrappers run their plain PyTorch versions, which repeat
the CUDA kernels' arithmetic in the same order.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import batch as RB
from repro.core import costs as RC
from repro.core import CostWeights as RWeights, Job as RJob, NetworkLink as RLink, SiteState as RSite
from repro.kernels.cost_matrix.ops import cost_matrix as jax_cost_matrix
from repro.kernels.cost_matrix.ops import cost_matrix_classed as jax_cost_matrix_classed

from repro_torch import sqrt_rn
from repro_torch.core import batch as PB
from repro_torch.core import state_from_reference, total_cost_matrix
from repro_torch.kernels.cost_matrix import ops as P_ops
from repro_torch.kernels.cost_matrix.ref import cost_argmin_f64_ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
from bulk_placement_bench import _build as bench_build  # noqa: E402

CPU = "cpu"


def _grid(rng, n_sites, dead_fraction=0.25, lossless_fraction=0.3):
    """tests/core/test_batch.py's grid: dead sites, lossless links, mss
    536/1460/9000."""
    sites, links = {}, {}
    for i in range(n_sites):
        name = f"s{i}"
        sites[name] = RSite(
            name=name, capacity=float(rng.integers(10, 2000)),
            queue_length=float(rng.integers(0, 100)),
            waiting_work=float(rng.uniform(0, 1000)),
            load=float(rng.uniform(0, 1)),
            alive=bool(rng.uniform() > dead_fraction),
        )
        links[name] = RLink(
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
        RJob(
            user=f"u{i % 3}",
            compute_work=float(rng.uniform(0.1, 200)),
            input_bytes=float(rng.uniform(0, 50e9)),
            output_bytes=float(rng.uniform(0, 1e9)),
        )
        for i in range(n)
    ]


def _packs(sites, links, jobs, job_classes=None):
    """Reference packs and the port's packs (on the host) of one state."""
    st = state_from_reference(sites, links, jobs)
    classes = None
    if job_classes is not None:
        classes = [PB.JobClass(c.value) for c in job_classes]
    return (
        RB.JobPack.from_jobs(jobs, job_classes),
        RB.SitePack.from_scheduler(sites, links),
        PB.JobPack.from_jobs(st.jobs, classes, device=CPU),
        PB.SitePack.from_scheduler(st.sites, st.links, device=CPU),
    )


class TestFloat32AgainstPallas:
    @pytest.mark.parametrize("J,S", [(1, 1), (5, 3), (300, 130), (1024, 128)])
    def test_cost_matrix(self, J, S):
        """tests/kernels/test_kernels.py:40's sweep, all-ones class masks."""
        rng = np.random.default_rng(J * 1000 + S)
        jb = rng.uniform(0, 1e10, J).astype(np.float32)
        jw = rng.uniform(1, 100, J).astype(np.float32)
        cap = rng.uniform(10, 1000, S).astype(np.float32)
        qi = rng.uniform(0, 50, S).astype(np.float32)
        qw = rng.uniform(0, 500, S).astype(np.float32)
        load = rng.uniform(0, 1, S).astype(np.float32)
        bw = rng.uniform(1e8, 1e10, S).astype(np.float32)
        loss = rng.uniform(0, 0.05, S).astype(np.float32)
        rtt = rng.uniform(0.01, 0.3, S).astype(np.float32)
        alive = (rng.uniform(0, 1, S) > 0.2).astype(np.float32)
        ck, bk = jax_cost_matrix(jb, jw, cap, qi, qw, load, bw, loss, rtt, alive,
                                 use_kernel=True, interpret=True)
        t = torch.from_numpy
        cp, bp = P_ops.cost_matrix(t(jb), t(jw), t(cap), t(qi), t(qw), t(load), t(bw),
                                   t(loss), t(rtt), t(alive > 0.5))
        np.testing.assert_allclose(cp.numpy(), np.asarray(ck), rtol=1e-5)
        np.testing.assert_array_equal(bp.numpy(), np.asarray(bk))
        assert bp.dtype == torch.int32

    @pytest.mark.parametrize("J,S", [(1, 1), (7, 5), (256, 128), (257, 129), (300, 130)])
    def test_cost_matrix_classed(self, J, S):
        """tests/core/test_batch.py:73's shapes: per-class masks, dead
        sites, lossless links, per-link mss."""
        rng = np.random.default_rng(J * 1000 + S)
        sites, links = _grid(rng, S)
        jobs = _jobs(rng, J)
        jr, sr, jp, sp = _packs(sites, links, jobs)
        w = dict(w_queue=0.5, w_work=2.0, w_load=1.5)
        ck, bk = jax_cost_matrix_classed(
            jr.bytes_, jr.work, jr.wcomp, jr.wdtc,
            sr.cap, sr.queue, sr.work, sr.load, sr.bw, sr.loss, sr.rtt, sr.alive, sr.mss,
            use_kernel=True, interpret=True, **w,
        )
        f = lambda x: x.float()  # noqa: E731
        cp, bp = P_ops.cost_matrix_classed(
            f(jp.bytes_), f(jp.work), f(jp.wcomp), f(jp.wdtc),
            f(sp.cap), f(sp.queue), f(sp.work), f(sp.load), f(sp.bw), f(sp.loss),
            f(sp.rtt), sp.alive, f(sp.mss), **w,
        )
        np.testing.assert_allclose(cp.numpy(), np.asarray(ck), rtol=1e-5)
        np.testing.assert_array_equal(bp.numpy(), np.asarray(bk))
        assert np.all(cp.numpy()[:, ~sr.alive] == np.float32(3.0e38))

    @pytest.mark.parametrize("mask_dead", [True, False])
    def test_batched_kernel_backend(self, mask_dead):
        rng = np.random.default_rng(41)
        sites, links = _grid(rng, 37)
        jobs = _jobs(rng, 53)
        jr, sr, jp, sp = _packs(sites, links, jobs)
        ref = RB.batched_cost_matrix(jr, sr, backend="kernel", mask_dead=mask_dead)
        port = PB.batched_cost_matrix(jp, sp, backend="kernel", mask_dead=mask_dead).numpy()
        assert port.dtype == np.float64
        np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(port[fin], ref[fin], rtol=1e-5)

    def test_total_cost_matrix(self):
        rng = np.random.default_rng(5)
        J, S = 40, 17
        cols = dict(
            job_bytes=rng.uniform(0, 1e10, J), job_work=rng.uniform(1, 100, J),
            site_capacity=rng.uniform(10, 1000, S), site_queue=rng.uniform(0, 50, S),
            site_work=rng.uniform(0, 500, S), site_load=rng.uniform(0, 1, S),
            link_bandwidth=rng.uniform(1e8, 1e10, S),
            link_loss=np.where(rng.uniform(size=S) < 0.3, 0.0, rng.uniform(1e-4, 0.05, S)),
            alive=rng.uniform(size=S) > 0.25,
            link_rtt=rng.uniform(0.01, 0.3, S),
        )
        w = RWeights(w_queue=2.0, w_work=0.5, w_load=3.0)
        ref = np.asarray(RC.total_cost_matrix(**cols, weights=w))
        pw = state_from_reference({}, {}, weights=w).weights
        port = total_cost_matrix(**cols, weights=pw, device=CPU).numpy()
        assert port.dtype == np.float32
        np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(port[fin], ref[fin], rtol=1e-5)


class TestFloat64BitIdentical:
    @pytest.mark.parametrize(
        "seed,J,S,dead,lossless",
        [(0, 1, 1, 0.0, 0.0), (1, 7, 5, 0.25, 0.3), (2, 64, 33, 0.5, 0.5),
         (3, 300, 130, 0.25, 1.0), (4, 129, 257, 0.0, 0.0), (5, 50, 24, 0.9, 0.3)],
    )
    @pytest.mark.parametrize("mask_dead", [True, False])
    def test_plane(self, seed, J, S, dead, lossless, mask_dead):
        rng = np.random.default_rng(seed)
        sites, links = _grid(rng, S, dead_fraction=dead, lossless_fraction=lossless)
        jr, sr, jp, sp = _packs(sites, links, _jobs(rng, J))
        ref = RB.batched_cost_matrix(jr, sr, mask_dead=mask_dead, backend="numpy")
        port = PB.batched_cost_matrix(jp, sp, mask_dead=mask_dead).numpy()
        assert np.array_equal(port, ref)

    def test_plane_all_classes_and_weights(self):
        rng = np.random.default_rng(12)
        sites, links = _grid(rng, 21)
        jobs = _jobs(rng, 30)
        classes = [RB.JobClass.COMPUTE, RB.JobClass.DATA, RB.JobClass.BOTH] * 10
        jr, sr, jp, sp = _packs(sites, links, jobs, classes)
        w = RWeights(w_queue=0.3, w_work=1.7, w_load=2.9)
        pw = state_from_reference({}, {}, weights=w).weights
        ref = RB.batched_cost_matrix(jr, sr, w, backend="numpy")
        assert np.array_equal(PB.batched_cost_matrix(jp, sp, pw).numpy(), ref)

    def test_plane_bench_config(self):
        """10,000 jobs × 256 sites, seed 0 (the bulk bench). A float64
        torch.sqrt on the host misrounds one loss column here."""
        site_d, link_d, jobs = bench_build(10_000, 256, 0)
        jr, sr, jp, sp = _packs(site_d, link_d, jobs)
        ref = RB.batched_cost_matrix(jr, sr, backend="numpy")
        assert np.array_equal(PB.batched_cost_matrix(jp, sp).numpy(), ref)
        placement = PB.fused_argmin(jp, sp)
        expect = RB.batched_argmin(ref, sr)
        assert placement.sites == expect.sites
        assert placement.costs.tolist() == list(expect.costs)

    def test_sqrt_rn_matches_numpy(self):
        x = np.random.default_rng(0).uniform(1e-4, 0.05, 100_000)
        assert np.array_equal(sqrt_rn(torch.from_numpy(x)).numpy(), np.sqrt(x))

    @pytest.mark.parametrize("seed", range(4))
    def test_fused_argmin(self, seed):
        rng = np.random.default_rng(100 + seed)
        sites, links = _grid(rng, int(rng.integers(2, 40)))
        jr, sr, jp, sp = _packs(sites, links, _jobs(rng, int(rng.integers(1, 80))))
        expect = RB.batched_argmin(RB.batched_cost_matrix(jr, sr), sr)
        got = PB.fused_argmin(jp, sp)
        assert got.sites == expect.sites
        assert got.site_indices.tolist() == expect.site_indices.tolist()
        assert got.costs.tolist() == list(expect.costs)
        assert got.site_indices.dtype == torch.int64

    @pytest.mark.parametrize("seed", range(3))
    def test_batched_argmin_and_argmin_finite(self, seed):
        rng = np.random.default_rng(200 + seed)
        sites, links = _grid(rng, int(rng.integers(2, 30)))
        jr, sr, jp, sp = _packs(sites, links, _jobs(rng, 25))
        plane = RB.batched_cost_matrix(jr, sr)
        expect = RB.batched_argmin(plane, sr)
        got = PB.batched_argmin(torch.from_numpy(plane), sp)
        assert got.sites == expect.sites and got.costs.tolist() == list(expect.costs)
        for row in plane[:5]:
            assert PB.argmin_finite(torch.from_numpy(row)) == RB.argmin_finite(row)
        dead = np.full(4, np.inf)
        with pytest.raises(RuntimeError, match="no alive site"):
            PB.argmin_finite(torch.from_numpy(dead))

    def test_fused_argmin_tie_takes_first_index(self):
        sites = {n: RSite(name=n, capacity=100.0, queue_length=5.0, waiting_work=10.0, load=0.2)
                 for n in ("zeta", "alpha", "mid")}
        links = {n: RLink(bandwidth_Bps=1e9, loss_rate=0.001) for n in sites}
        jobs = [RJob(user="u", compute_work=5.0, input_bytes=2e9)]
        jr, sr, jp, sp = _packs(sites, links, jobs)
        expect = RB.batched_argmin(RB.batched_cost_matrix(jr, sr), sr)
        got = PB.fused_argmin(jp, sp)
        assert got.sites == expect.sites == ["zeta"]
        assert got.costs.tolist() == list(expect.costs)

    def test_fused_argmin_all_dead_raises(self):
        rng = np.random.default_rng(1)
        sites, links = _grid(rng, 4, dead_fraction=0.0)
        for s in sites.values():
            s.alive = False
        jr, sr, jp, sp = _packs(sites, links, _jobs(rng, 3))
        with pytest.raises(RuntimeError, match="no alive site"):
            RB.batched_argmin(RB.batched_cost_matrix(jr, sr), sr)
        with pytest.raises(RuntimeError, match="no alive site"):
            PB.fused_argmin(jp, sp)

    def test_fused_argmin_nan_counts_as_minimum(self):
        """A 0-bandwidth lossless link gives 0/0 = NaN network cost: both
        np.argmin and the port pick that column, and it is not finite."""
        sites = {n: RSite(name=n, capacity=100.0) for n in ("a", "b", "c", "d")}
        links = {n: RLink(bandwidth_Bps=1e9) for n in sites}
        links["c"] = RLink(bandwidth_Bps=0.0)
        jobs = [RJob(user="u", compute_work=5.0), RJob(user="u", compute_work=50.0, input_bytes=9e9)]
        jr, sr, jp, sp = _packs(sites, links, jobs)
        ref_plane = RB.batched_cost_matrix(jr, sr)
        assert np.isnan(ref_plane[:, 2]).all()
        best, cost = cost_argmin_f64_ref(
            jp.bytes_, jp.work, jp.cls, sp.pack_rows(), sp.alive)
        assert best.tolist() == np.argmin(ref_plane, axis=1).tolist() == [2, 2]
        assert torch.isnan(cost).all()
        with pytest.raises(RuntimeError, match="no alive site"):
            PB.fused_argmin(jp, sp)

    def test_no_sites_raises(self):
        jp = PB.JobPack.from_jobs([PB.Job(user="u")], device=CPU)
        sp = PB.SitePack.from_scheduler({}, {}, device=CPU)
        with pytest.raises(RuntimeError, match="no alive site"):
            PB.fused_argmin(jp, sp)

    def test_components_and_class_totals(self):
        rng = np.random.default_rng(77)
        sites, links = _grid(rng, 19)
        jr, sr, jp, sp = _packs(sites, links, _jobs(rng, 11))
        ref = RB.cost_components(jr, sr)
        port = PB.cost_components(jp, sp)
        for a, b in zip(port, ref):
            assert np.array_equal(a.numpy(), b)
        net, comp, dtc = ref
        pnet, pcomp, pdtc = port
        for rc, pc in zip(RB.JobClass, PB.JobClass):
            assert np.array_equal(
                PB.class_total(pc, pnet, pcomp, pdtc).numpy(), RB.class_total(rc, net, comp, dtc)
            )
