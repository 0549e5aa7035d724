"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device; on a
machine with the card and nvcc run ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. This file imports neither JAX nor the
reference package, so it also runs where only the port is installed.
Shapes are ragged on purpose: no dimension is a multiple of a tile.
"""
import copy

import numpy as np
import pytest
import torch

import repro_torch.core as P
from repro_torch.core import batch as PB
from repro_torch.kernels.cost_matrix import ops as cm_ops, ref as cm_ref
from repro_torch.kernels.priority_requeue import ops as pr_ops, ref as pr_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(seed, n_sites, n_jobs, dead=0.25):
    rng = np.random.default_rng(seed)
    sites, links = {}, {}
    for i in range(n_sites):
        name = f"s{i}"
        sites[name] = P.SiteState(
            name=name, capacity=float(rng.integers(10, 2000)),
            queue_length=float(rng.integers(0, 100)), waiting_work=float(rng.uniform(0, 1000)),
            load=float(rng.uniform(0, 1)), alive=bool(rng.uniform() > dead),
        )
        links[name] = P.NetworkLink(
            bandwidth_Bps=float(rng.uniform(1e8, 1e10)),
            loss_rate=0.0 if rng.uniform() < 0.3 else float(rng.uniform(1e-4, 0.05)),
            rtt_s=float(rng.uniform(0.001, 0.3)),
            mss_bytes=float(rng.choice([536.0, 1460.0, 9000.0])),
        )
    jobs = [P.Job(user=f"u{i % 3}", compute_work=float(rng.uniform(0.1, 200)),
                  input_bytes=float(rng.uniform(0, 50e9)), output_bytes=float(rng.uniform(0, 1e9)))
            for i in range(n_jobs)]
    return sites, links, jobs


SHAPES = [(1, 1), (7, 5), (65, 33), (300, 257), (1000, 1030)]


@pytest.mark.parametrize("J,S", SHAPES)
def test_cost_matrix_f64_and_argmin(dev, J, S):
    sites, links, jobs = _state(J + S, S, J)
    sp = PB.SitePack.from_scheduler(sites, links, device=dev)
    jp = PB.JobPack.from_jobs(jobs, device=dev)
    args = (jp.bytes_, jp.work, jp.cls, sp.pack_rows(), sp.alive)
    w = dict(w_queue=0.5, w_work=1.5, w_load=2.0)
    for mask_dead in (True, False):
        before = cm_ops.cost_matrix_f64.launches
        k = cm_ops.cost_matrix_f64(*args, mask_dead=mask_dead, **w)
        assert cm_ops.cost_matrix_f64.launches == before + 1
        p = cm_ref.cost_matrix_f64_ref(*args, 0.5, 1.5, 2.0, mask_dead)
        assert torch.equal(k, p)
    if not bool(sp.alive.any()):
        with pytest.raises(RuntimeError, match="no alive site"):
            cm_ops.cost_argmin_f64(*args, **w)
        return
    bk, ck = cm_ops.cost_argmin_f64(*args, **w)
    bp, cp = cm_ref.cost_argmin_f64_ref(*args, 0.5, 1.5, 2.0)
    assert torch.equal(bk, bp) and torch.equal(ck, cp)
    host = PB.SitePack.from_scheduler(sites, links, device="cpu")
    hp = PB.JobPack.from_jobs(jobs, device="cpu")
    assert torch.equal(k.cpu(), cm_ops.cost_matrix_f64(
        hp.bytes_, hp.work, hp.cls, host.pack_rows(), host.alive, mask_dead=False, **w))


@pytest.mark.parametrize("J,S", SHAPES)
def test_cost_matrix_f32(dev, J, S):
    sites, links, jobs = _state(7 * J + S, S, J)
    sp = PB.SitePack.from_scheduler(sites, links, device=dev)
    jp = PB.JobPack.from_jobs(jobs, device=dev)
    f = lambda t: t.float()  # noqa: E731
    jobs32 = [f(jp.bytes_), f(jp.work), f(jp.wcomp), f(jp.wdtc)]
    sites32 = [f(getattr(sp, c)) for c in ("cap", "queue", "work", "load", "bw", "loss", "rtt")]
    ck, bk = cm_ops.cost_matrix_classed(*jobs32, *sites32, sp.alive, f(sp.mss), w_queue=2.0)
    rows9 = torch.stack([*sites32, sp.alive.float(), f(sp.mss)])
    cp = cm_ref.cost_matrix_f32_ref(*jobs32, rows9, 2.0)
    assert torch.equal(ck, cp)
    assert torch.equal(bk, torch.argmin(cp, dim=1).to(torch.int32))


def test_argmin_tie_and_nan(dev):
    sites = {n: P.SiteState(name=n, capacity=100.0) for n in "abcd"}
    links = {n: P.NetworkLink(bandwidth_Bps=1e9, loss_rate=0.001) for n in sites}
    jobs = [P.Job(user="u", compute_work=5.0)]
    sp = PB.SitePack.from_scheduler(sites, links, device=dev)
    jp = PB.JobPack.from_jobs(jobs, device=dev)
    assert PB.fused_argmin(jp, sp).site_indices.tolist() == [0]
    links["c"] = P.NetworkLink(bandwidth_Bps=0.0)   # 0/0: NaN network cost
    sp = PB.SitePack.from_scheduler(sites, links, device=dev)
    with pytest.raises(RuntimeError, match="no alive site"):
        PB.fused_argmin(jp, sp)


@pytest.mark.parametrize("L", [1, 255, 257, 10_000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_priority_requeue(dev, L, dtype):
    rng = np.random.default_rng(L)
    n, q, t = rng.integers(1, 50, L).astype(np.float64), rng.uniform(10, 5000, L), rng.uniform(1, 64, L)
    Q, T = float(q.sum()), float(t.sum())
    nt, qt, tt = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (n, q, t))
    before = pr_ops.priority_requeue.launches
    prk, bk = pr_ops.priority_requeue(nt, qt, tt, Q, T)
    assert pr_ops.priority_requeue.launches == before + 1
    prp, bp = pr_ref.priority_requeue_ref(nt, qt, tt, Q, T)
    assert torch.equal(prk, prp) and torch.equal(bk, bp)
    if dtype == torch.float64:
        pr_np, b_np = P.reprioritize_np(n, q, t, Q, T)
        assert np.array_equal(prk.cpu().numpy(), pr_np) and np.array_equal(bk.cpu().numpy(), b_np)


def test_wrapper_rejects_bad_cuda_input(dev):
    n = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="several devices"):
        pr_ops.priority_requeue(n, n, n.cpu(), 1.0, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        m = torch.ones((8, 2), device=dev)[:, 0]
        pr_ops.priority_requeue(m, m, m, 1.0, 1.0)


def test_scheduler_on_the_card_equals_the_host(dev):
    sites, links, jobs = _state(3, 40, 300)
    gpu = P.DianaScheduler(copy.deepcopy(sites), dict(links), device=dev)
    cpu = P.DianaScheduler(copy.deepcopy(sites), dict(links), device="cpu")
    a, b = gpu.select_sites_batch(jobs), cpu.select_sites_batch(jobs)
    assert a.sites == b.sites and a.costs.tolist() == b.costs.tolist()
    assert gpu.rank_sites_batch(jobs) == cpu.rank_sites_batch(jobs)
    a, b = gpu.place_batch(copy.deepcopy(jobs)), cpu.place_batch(copy.deepcopy(jobs))
    assert a.sites == b.sites and a.costs.tolist() == b.costs.tolist()
    assert all(gpu.sites[n].queue_length == cpu.sites[n].queue_length for n in sites)
