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
from repro_torch.kernels.cost_matrix import cases as cm_cases, ops as cm_ops, ref as cm_ref
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


def _same(a, b):
    """Equal values, NaN where NaN."""
    an, bn = a.isnan(), b.isnan()
    return torch.equal(an, bn) and torch.equal(a[~an], b[~bn])


def _f32_case_checks(case, dev):
    """The f32 plane bit-equal to its plain version on one case
    (cost_matrix.cases, as ``tensors_f32`` packs it), NaN where NaN, with
    the same first-index argmin."""
    args, w = cm_cases.tensors_f32(case, dev)
    before = cm_ops.cost_matrix_classed.launches
    ck, bk = cm_ops.cost_matrix_classed(*args, **w)
    assert cm_ops.cost_matrix_classed.launches == before + 1
    cp, bp = cm_ref.cost_matrix_classed_ref(*args, **w)
    assert _same(ck, cp)
    assert torch.equal(bk, bp)


@pytest.mark.parametrize("name", cm_cases.ADVERSARIAL + cm_cases.ADVERSARIAL_F32)
def test_f32_plane_on_the_edge_cases(dev, name):
    """The f64 sets cast to float32 (bytes and work beyond its range
    become inf or 0) and the f32 sets: operands at and outside the exact
    division's window, FLT_MIN capacities, 3e38 jobs, loss at the clamp,
    inf and NaN columns, 0·inf, two lanes one ulp apart."""
    _f32_case_checks(cm_cases.adversarial(name), dev)


@pytest.mark.parametrize("J,S", [(1, 1), (7, 5), (33, 1027), (257, 4099), (65, 1024), (100, 130)])
def test_f32_plane_on_ragged_shapes(dev, J, S):
    """S % 4 != 0 (rows start misaligned: scalar stores up to the last,
    partial quad), several column tiles, J off a warp's 32 rows."""
    _f32_case_checks(cm_cases.ragged(J, S, seed=J + S), dev)


def _f64_case_checks(case, dev):
    """Both f64 entries bit-equal to their plain versions on one case
    (cost_matrix.cases), NaN and +inf picks included."""
    args, w = cm_cases.tensors(case, dev)
    wq, ww, wl = w.values()
    for mask_dead in (True, False):
        k = cm_ops.cost_matrix_f64(*args, mask_dead=mask_dead, **w)
        assert _same(k, cm_ref.cost_matrix_f64_ref(*args, wq, ww, wl, mask_dead))
    bk, ck = cm_ops.argmin_f64_unchecked(*args, **w)
    bp, cp = cm_ref.cost_argmin_f64_ref(*args, wq, ww, wl)
    assert torch.equal(bk, bp) and _same(ck, cp)


@pytest.mark.parametrize("name", cm_cases.ADVERSARIAL)
def test_f64_kernels_on_the_edge_cases(dev, name):
    """One-ulp reversals of the screen's estimates, ties, NaN and inf
    cells, the gate off, dead columns, zero bytes, subnormal and
    near-overflow costs (rows outside the fast division's range go
    through the fix-up pass)."""
    _f64_case_checks(cm_cases.adversarial(name), dev)


@pytest.mark.parametrize("S", [1, 31, 33, 255, 1025, 4097])
@pytest.mark.parametrize("J", [1, 63, 64, 65, 100_003])
def test_f64_kernels_on_ragged_shapes(dev, J, S):
    """Every pad of the 32 lanes, S odd (shifted double2 slots), J across
    the rows a warp carries, a block's rows and many waves."""
    _f64_case_checks(cm_cases.ragged(J, S, seed=J + 7 * S), dev)


def test_f64_fixup_rows_and_columns(dev):
    """Cells outside the fast division's range: a tiny job (bytes 1e-200),
    a site whose capacity is 1e-300, one whose bandwidth is 1e300."""
    case = cm_cases.ragged(200, 300, seed=4)
    case["bytes_"][7] = 1e-200
    case["work"][9] = 1e200
    case["rows"][0, 11] = 1e-300          # cap
    case["rows"][4, 13], case["rows"][5, 13] = 1e300, 0.0   # bw, lossless
    case["alive"][[11, 13]] = True
    _f64_case_checks(case, dev)


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


# -- attention kernels --------------------------------------------------------

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops, ref as da_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref  # noqa: E402
from repro_torch.models import LM, decode  # noqa: E402

# The JAX kernel tests' cases (tests/kernels/test_kernels.py ATTN_CASES,
# DECODE_CASES) plus ragged lengths, D 32, a window on a long row, and
# float32 rows over many key tiles (flash: 64 keys) and many splits
# (decode: 256 keys), where the cross-tile rescale shows at 2e-5.
FLASH_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, softcap, dtype)
    (1, 128, 128, 4, 4, 64, True, 0, 0.0, torch.float32),
    (2, 256, 256, 4, 2, 64, True, 0, 0.0, torch.float32),
    (1, 128, 128, 8, 1, 128, True, 64, 0.0, torch.float32),
    (1, 256, 256, 4, 4, 128, True, 0, 50.0, torch.float32),
    (1, 128, 128, 4, 4, 256, True, 0, 0.0, torch.bfloat16),
    (1, 128, 256, 2, 2, 64, False, 0, 0.0, torch.float32),
    (2, 200, 200, 4, 2, 256, True, 96, 50.0, torch.bfloat16),
    (1, 77, 77, 4, 2, 32, True, 0, 0.0, torch.bfloat16),
    (1, 77, 77, 4, 2, 32, True, 16, 0.0, torch.float32),
    (1, 300, 300, 8, 4, 128, True, 0, 0.0, torch.bfloat16),
    (1, 1024, 1024, 4, 2, 128, True, 0, 50.0, torch.float32),
    (1, 1024, 1024, 8, 4, 256, True, 300, 50.0, torch.float32),
    # the hybrid, vision and whisper families' shapes (chip_smoke.py phase 8):
    # rep 10 over one kv head at D 256 (window 2048; the f32 checks' 16 and
    # 24 tokens, the cut window of 16), D 128 causal and non-causal with
    # Sq > Sk = 1,601, D 64 non-causal 1,500 x 1,500 and 448 x 1,500
    (1, 4096, 4096, 10, 1, 256, True, 2048, 0.0, torch.bfloat16),
    (2, 16, 16, 10, 1, 256, True, 2048, 0.0, torch.float32),
    (2, 24, 24, 10, 1, 256, True, 16, 0.0, torch.float32),
    (1, 2048, 2048, 32, 8, 128, True, 0, 0.0, torch.bfloat16),
    (1, 2048, 1601, 32, 8, 128, False, 0, 0.0, torch.bfloat16),
    (2, 16, 1601, 32, 8, 128, False, 0, 0.0, torch.float32),
    (1, 1500, 1500, 8, 8, 64, False, 0, 0.0, torch.bfloat16),
    (2, 1500, 1500, 8, 8, 64, False, 0, 0.0, torch.float32),
    (1, 448, 448, 8, 8, 64, True, 0, 0.0, torch.bfloat16),
    (1, 448, 1500, 8, 8, 64, False, 0, 0.0, torch.bfloat16),
    (2, 16, 1500, 8, 8, 64, False, 0, 0.0, torch.float32),
]
DECODE_CASES = [
    # (B, S, H, KV, D, pos, window, softcap, dtype)
    (1, 128, 4, 4, 64, 0, 0, 0.0, torch.float32),
    (2, 512, 8, 2, 64, 100, 0, 0.0, torch.float32),
    (1, 512, 8, 1, 128, 511, 64, 0.0, torch.float32),
    (2, 256, 16, 8, 256, 200, 0, 50.0, torch.float32),
    (1, 512, 8, 8, 128, 300, 0, 0.0, torch.bfloat16),
    (3, 1000, 16, 8, 256, 999, 300, 50.0, torch.bfloat16),
    (2, 64, 4, 2, 32, 40, 0, 0.0, torch.bfloat16),
    (2, 8192, 16, 8, 256, 8191, 0, 50.0, torch.float32),
    (1, 8192, 16, 8, 256, 6000, 4096, 50.0, torch.float32),
    (1, 3000, 8, 2, 128, 2500, 0, 0.0, torch.float32),
    # phase 8's: rep 10 over the 64-slot and 2,048 rings (and the f32
    # checks' rings of 24 and 16), the vision and whisper self caches and
    # their cross layers read to the last image token or frame
    (4, 64, 10, 1, 256, 63, 0, 0.0, torch.bfloat16),
    (1, 2048, 10, 1, 256, 2047, 0, 0.0, torch.bfloat16),
    (2, 24, 10, 1, 256, 15, 0, 0.0, torch.float32),
    (2, 16, 10, 1, 256, 15, 0, 0.0, torch.float32),
    (1, 64, 32, 8, 128, 31, 0, 0.0, torch.bfloat16),
    (1, 1601, 32, 8, 128, 1600, 0, 0.0, torch.bfloat16),
    (2, 1601, 32, 8, 128, 1600, 0, 0.0, torch.float32),
    (1, 448, 8, 8, 64, 447, 0, 0.0, torch.bfloat16),
    (1, 1500, 8, 8, 64, 1499, 0, 0.0, torch.bfloat16),
    (2, 1500, 8, 8, 64, 1499, 0, 0.0, torch.float32),
]


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def _randn(rng, shape, dtype, dev, scale=1.0):
    return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32).to(dev, dtype)


def _qkv(rng, q_shape, kv_shape, dtype, dev):
    """q and k of standard deviation 1.5, so that scores spread over
    several units as a trained model's do; v standard normal."""
    return (_randn(rng, q_shape, dtype, dev, 1.5), _randn(rng, kv_shape, dtype, dev, 1.5),
            _randn(rng, kv_shape, dtype, dev))


def _agree(out, ref, dtype):
    """Within the JAX kernel tests' tolerance, and the mean error under 1%
    of the mean |ref| (rounding gives about 0.2% in bf16; a missing rescale
    between key tiles or splits moves the output by a large share of itself)."""
    torch.testing.assert_close(out.float(), ref.float(), rtol=_tol(dtype), atol=_tol(dtype))
    err = float((out.float() - ref.float()).abs().mean())
    assert err <= 0.01 * float(ref.float().abs().mean())


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_kernel(dev, case):
    B, Sq, Sk, H, KV, D, causal, window, cap, dt = case
    rng = np.random.default_rng(Sq * 7 + D)
    q, k, v = _qkv(rng, (B, Sq, H, D), (B, Sk, KV, D), dt, dev)
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    ref = fa_ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
    _agree(out, ref, dt)


def test_flash_attention_reads_strides(dev):
    """q, k, v as column slices of one fused projection (B, S, H+2KV, D)."""
    rng = np.random.default_rng(5)
    qkv = _randn(rng, (2, 130, 16 + 16, 256), torch.bfloat16, dev, 1.5)
    q, k, v = qkv[:, :, :16], qkv[:, :, 16:24], qkv[:, :, 24:]
    out = fa_ops.flash_attention(q, k, v, window=64, softcap=50.0)
    ref = fa_ref.flash_attention_ref(q, k, v, window=64, softcap=50.0)
    _agree(out, ref, torch.bfloat16)


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_attention_kernel(dev, case):
    B, S, H, KV, D, pos, window, cap, dt = case
    rng = np.random.default_rng(S + pos)
    q, k, v = _qkv(rng, (B, H, D), (B, S, KV, D), dt, dev)
    before = da_ops.decode_attention.launches
    out = da_ops.decode_attention(q, k, v, pos, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert da_ops.decode_attention.launches == before + 1
    ref = da_ref.decode_attention_ref(q, k, v, pos, window=window, softcap=cap)
    _agree(out, ref, dt)


def test_decode_attention_ring_and_layer_slice(dev):
    """A ring layer of a stacked cache (a strided view) read up to
    min(pos, W − 1) equals the plain version on the same view."""
    rng = np.random.default_rng(9)
    cache = _randn(rng, (3, 2, 4, 96, 8, 256), torch.bfloat16, dev, 1.5)
    k, v = cache[1, 1], cache[2, 0]
    q = _randn(rng, (4, 16, 256), torch.bfloat16, dev, 1.5)
    for pos in (0, 50, 95):
        out = da_ops.decode_attention(q, k, v, pos, softcap=50.0)
        ref = da_ref.decode_attention_ref(q, k, v, pos, softcap=50.0)
        _agree(out, ref, torch.bfloat16)


# The bf16 flash body's edges: every head dim, ragged Sq and Sk (77,
# 200, 1000: no multiple of the 128-row query tile or the 64-key tile),
# a window edge inside a key tile, non-causal Sq < Sk, rep 1, 2 and 4, and
# bf16 rows over 32 and more key tiles (a missing rescale or a ring stage
# read before its barrier completes shows there).
FLASH_BF16_EDGES = [
    # (B, Sq, Sk, H, KV, D, causal, window, softcap)
    (1, 77, 77, 4, 4, 32, True, 0, 0.0),
    (2, 200, 200, 4, 2, 64, True, 0, 50.0),
    (1, 1000, 1000, 8, 2, 128, True, 0, 0.0),
    (1, 1000, 1000, 4, 2, 256, True, 0, 50.0),
    (1, 77, 77, 2, 1, 32, True, 20, 50.0),
    (1, 200, 200, 4, 1, 256, True, 100, 0.0),
    (1, 1000, 1000, 2, 2, 64, True, 333, 50.0),
    (1, 77, 200, 4, 2, 128, False, 0, 0.0),
    (2, 200, 1000, 2, 2, 256, False, 0, 50.0),
    (1, 2048, 2048, 4, 4, 128, True, 0, 0.0),
    (1, 2304, 2304, 2, 1, 256, True, 0, 50.0),
    (1, 2304, 2304, 4, 2, 256, True, 1000, 50.0),
]


@pytest.mark.parametrize("case", FLASH_BF16_EDGES, ids=str)
def test_flash_attention_bf16_edges(dev, case):
    B, Sq, Sk, H, KV, D, causal, window, cap = case
    rng = np.random.default_rng(Sq * 13 + Sk + D + window)
    q, k, v = _qkv(rng, (B, Sq, H, D), (B, Sk, KV, D), torch.bfloat16, dev)
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    ref = fa_ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
    _agree(out, ref, torch.bfloat16)


@pytest.mark.parametrize("D", fa_ops.HEAD_DIMS)
def test_flash_attention_bf16_fused_qkv_slices(dev, D):
    """q, k, v as strided slices of one fused (B, S, H + 2 KV, D) tensor,
    at every head dim (the tensor maps read through the strides)."""
    rng = np.random.default_rng(D)
    qkv = _randn(rng, (2, 200, 8 + 4, D), torch.bfloat16, dev, 1.5)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out = fa_ops.flash_attention(q, k, v, window=70, softcap=50.0)
    ref = fa_ref.flash_attention_ref(q, k, v, window=70, softcap=50.0)
    _agree(out, ref, torch.bfloat16)


# MLA's (DQK 192, DV 128) instance: k and v two column ranges of one
# (B, S, KV, 320) buffer, as models.mla builds them; ragged lengths,
# causal and not, both types, and deepseek's 128 heads at 1,000 tokens.
FLASH_MLA_CASES = [
    # (B, Sq, Sk, H, KV, causal, dtype)
    (1, 77, 77, 4, 4, True, torch.bfloat16),
    (2, 200, 200, 4, 4, True, torch.bfloat16),
    (1, 1000, 1000, 128, 128, True, torch.bfloat16),
    (1, 4096, 4096, 2, 2, True, torch.bfloat16),
    (1, 200, 1000, 4, 2, False, torch.bfloat16),
    (1, 77, 77, 4, 4, False, torch.float32),
    (2, 200, 200, 4, 4, True, torch.float32),
    (1, 1000, 1000, 4, 2, True, torch.float32),
]


@pytest.mark.parametrize("case", FLASH_MLA_CASES, ids=str)
def test_flash_attention_mla_instance(dev, case):
    B, Sq, Sk, H, KV, causal, dt = case
    rng = np.random.default_rng(Sq + Sk + H)
    q = _randn(rng, (B, Sq, H, 192), dt, dev, 1.5)
    kv = torch.cat([_randn(rng, (B, Sk, KV, 192), dt, dev, 1.5), _randn(rng, (B, Sk, KV, 128), dt, dev)], -1)
    k, v = kv[..., :192], kv[..., 192:]
    before = fa_ops.flash_attention.launches, fa_ops.flash_attention.by_pair.get((192, 128), 0)
    out = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before[0] + 1 and out.shape == (B, Sq, H, 128)
    assert fa_ops.flash_attention.by_pair[(192, 128)] == before[1] + 1
    _agree(out, fa_ref.flash_attention_ref(q, k, v, causal=causal), dt)


def test_flash_attention_refuses_pairs_without_an_instance(dev):
    """A width no instance covers (D 320; Dv wider than any instance as
    wide as D) raises; an instance's own widths still need k and v to
    share their strides (the padded route builds its own buffer)."""
    q = torch.ones((1, 8, 2, 320), device=dev)
    with pytest.raises(ValueError, match="takes D"):
        fa_ops.flash_attention(q, q, q)                                    # (320, 320)
    with pytest.raises(ValueError, match="takes D"):
        fa_ops.flash_attention(q[..., :64], q[..., :64], q[..., :300])     # (64, 300)
    q = torch.ones((1, 8, 2, 192), device=dev)
    kv = torch.ones((1, 8, 2, 256), device=dev)
    with pytest.raises(ValueError, match="same strides"):
        fa_ops.flash_attention(q, kv[..., :192].contiguous(), kv[..., :128].contiguous())


# The padded route (C6): widths with no instance run the smallest one that
# covers them, on zero-padded q, k and v at the true width's scale; MLA's
# reduced (48, 32), the 100m preset's head_dim 80 and (192, 64), forward
# and backward, both types; k and v as column ranges of one buffer and,
# for (80, 80), as separate tensors with their own strides.
FLASH_PADDED_CASES = [
    # (B, Sq, Sk, H, KV, D, Dv, causal, window, softcap)
    (1, 200, 200, 4, 2, 48, 32, True, 0, 0.0),
    (2, 130, 130, 8, 4, 80, 80, True, 50, 50.0),
    (1, 77, 200, 4, 4, 192, 64, False, 0, 0.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", FLASH_PADDED_CASES, ids=str)
def test_flash_attention_padded_route(dev, case, dtype):
    B, Sq, Sk, H, KV, D, Dv, causal, window, cap = case
    rng = np.random.default_rng(Sq + D + Dv)
    q = _randn(rng, (B, Sq, H, D), dtype, dev, 1.5)
    if D == Dv:
        k, v = _randn(rng, (B, Sk, KV, D), dtype, dev, 1.5), _randn(rng, (B, Sk, KV, Dv), dtype, dev)
    else:
        kv = torch.cat([_randn(rng, (B, Sk, KV, D), dtype, dev, 1.5), _randn(rng, (B, Sk, KV, Dv), dtype, dev)], -1)
        k, v = kv[..., :D], kv[..., D:]
    do = _randn(rng, (B, Sq, H, Dv), dtype, dev)
    pair = fa_ops.instance(D, Dv)
    opts = dict(causal=causal, window=window, softcap=cap)
    before = (fa_ops.flash_attention.padded, fa_ops.flash_attention.by_pair.get(pair, 0),
              fa_ops.flash_attention_bwd.padded, fa_ops.flash_attention_bwd.by_pair.get(pair, 0))
    o, lse = fa_ops.flash_attention(q, k, v, return_lse=True, **opts)
    got = fa_ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **opts)
    torch.cuda.synchronize()
    after = (fa_ops.flash_attention.padded, fa_ops.flash_attention.by_pair.get(pair, 0),
             fa_ops.flash_attention_bwd.padded, fa_ops.flash_attention_bwd.by_pair.get(pair, 0))
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]
    assert o.shape == (B, Sq, H, Dv) and [g.shape for g in got] == [q.shape, k.shape, v.shape]
    plain_o, plain_lse = fa_ref.flash_attention_ref(q, k, v, return_lse=True, **opts)
    _agree(o, plain_o, dtype)
    torch.testing.assert_close(lse, plain_lse, rtol=1e-4, atol=1e-4 * float(plain_lse.abs().max()))
    _grads_agree(got, fa_ref.flash_attention_bwd_ref(q, k, v, o, do, **opts), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("D", [48, 80])
def test_decode_attention_padded_route(dev, D, dtype):
    rng = np.random.default_rng(D)
    q, k, v = _qkv(rng, (4, 8, D), (4, 300, 2, D), dtype, dev)
    before = da_ops.decode_attention.padded
    for pos, window, cap in ((299, 0, 50.0), (250, 100, 0.0)):
        out = da_ops.decode_attention(q, k, v, pos, window=window, softcap=cap)
        assert out.shape == (4, 8, D)
        _agree(out, da_ref.decode_attention_ref(q, k, v, pos, window=window, softcap=cap), dtype)
    assert da_ops.decode_attention.padded == before + 2


def test_instance_widths_take_no_padding(dev):
    """Each instance's own widths run unpadded, the padded counters still."""
    rng = np.random.default_rng(2)
    before = fa_ops.flash_attention.padded, da_ops.decode_attention.padded
    for D, Dv in fa_ops.PAIRS:
        q = _randn(rng, (1, 70, 2, D), torch.bfloat16, dev)
        kv = _randn(rng, (1, 70, 2, D + Dv), torch.bfloat16, dev)
        fa_ops.flash_attention(q, kv[..., :D], kv[..., D:])
    for D in da_ops.HEAD_DIMS:
        q, k, v = _qkv(rng, (2, 4, D), (2, 50, 2, D), torch.bfloat16, dev)
        da_ops.decode_attention(q, k, v, 30)
    torch.cuda.synchronize()
    assert (fa_ops.flash_attention.padded, da_ops.decode_attention.padded) == before


# The split pass's edges: rep 1-16, S not a multiple of the 32-key chunk,
# pos inside the first chunk, a window edge inside a chunk; both types.
DECODE_EDGES = [
    # (B, S, H, KV, D, pos, window, softcap)
    (2, 77, 1, 1, 64, 76, 0, 0.0),
    (2, 77, 2, 1, 128, 5, 0, 50.0),
    (1, 1000, 3, 1, 256, 999, 0, 50.0),
    (3, 1000, 8, 2, 32, 640, 45, 0.0),
    (1, 333, 10, 2, 128, 300, 0, 50.0),
    (2, 4100, 16, 2, 64, 4099, 0, 0.0),
    (1, 4100, 16, 1, 256, 4000, 1000, 50.0),
    (2, 1000, 32, 2, 256, 17, 0, 50.0),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case", DECODE_EDGES, ids=str)
def test_decode_attention_edges(dev, case, dtype):
    B, S, H, KV, D, pos, window, cap = case
    rng = np.random.default_rng(S * 3 + H + pos)
    q, k, v = _qkv(rng, (B, H, D), (B, S, KV, D), dtype, dev)
    out = da_ops.decode_attention(q, k, v, pos, window=window, softcap=cap)
    ref = da_ref.decode_attention_ref(q, k, v, pos, window=window, softcap=cap)
    _agree(out, ref, dtype)


@pytest.mark.parametrize("W", [1, 2, 5, 64])
def test_decode_attention_rings(dev, W):
    """A ring of W slots read up to min(pos, W - 1), before and after it
    wraps, as models.decode reads it."""
    rng = np.random.default_rng(W)
    q, k, v = _qkv(rng, (4, 16, 256), (4, W, 8, 256), torch.bfloat16, dev)
    for pos in sorted({0, W - 1, W, 3 * W + 1, 300}):
        read = min(pos, W - 1)
        out = da_ops.decode_attention(q, k, v, read, softcap=50.0)
        ref = da_ref.decode_attention_ref(q, k, v, read, softcap=50.0)
        _agree(out, ref, torch.bfloat16)


# The key-range entry (key0, lse=True) at tests/test_torch_decode_range.py's
# cases: (B, S, H, KV, D, pos, window, softcap), rep 1, 2, 10 and 2; cut
# into m ranges, some wholly past pos or before the window.
RANGE_CASES = [
    (2, 512, 4, 4, 32, 511, 0, 50.0),
    (2, 512, 8, 4, 64, 200, 0, 0.0),
    (1, 1024, 10, 1, 128, 700, 300, 0.0),
    (3, 256, 16, 8, 32, 0, 0, 50.0),
    (2, 2048, 16, 8, 256, 1500, 4096, 50.0),
]


def _combine(pairs):
    outs, lses = torch.stack([o for o, _ in pairs]), torch.stack([m for _, m in pairs])
    M = lses.amax(0)
    w = torch.exp(lses - torch.where(torch.isfinite(M), M, torch.zeros_like(M)))
    return (w[..., None] * outs).sum(0) / w.sum(0)[..., None]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("case", RANGE_CASES, ids=str)
def test_decode_attention_key_range_entry(dev, case, m, dt):
    """Each range's (out, lse) from the kernel against the plain version on
    the same range (out at the type's tolerance, lse within 1e-4; −inf
    where the range sees no key), and the ranges combined against the
    whole-cache kernel."""
    B, S, H, KV, D, pos, window, cap = case
    rng = np.random.default_rng(S + pos + m)
    q, k, v = _qkv(rng, (B, H, D), (B, S, KV, D), dt, dev)
    n = S // m
    pairs = []
    before = da_ops.decode_attention.launches, da_ops.decode_attention.ranged
    for r in range(m):
        kw = dict(window=window, softcap=cap, key0=r * n, lse=True)
        out, lse = da_ops.decode_attention(q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n], pos, **kw)
        ref_out, ref_lse = da_ref.decode_attention_ref(q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n], pos, **kw)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32 and not torch.isnan(out).any() and not torch.isnan(lse).any()
        torch.testing.assert_close(out, ref_out, rtol=_tol(dt), atol=_tol(dt))
        torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
        if da_ops.visible_keys(pos, window=window, key0=r * n, S=n) == 0:
            assert torch.equal(out, torch.zeros_like(out)) and bool((lse == float("-inf")).all())
        pairs.append((out, lse))
    assert (da_ops.decode_attention.launches, da_ops.decode_attention.ranged) == (before[0] + m, before[1] + m)
    whole = da_ops.decode_attention(q, k, v, pos, window=window, softcap=cap)
    _agree(_combine(pairs).to(dt), whole, dt)


@pytest.mark.parametrize("pos", [0, 3, 510, 511, 512, 513, 600, 4095])
def test_decode_attention_key_ranges_of_a_ring(dev, pos):
    """A 512-slot ring cut into 4 ranges, each read to pos' = min(pos, W − 1)."""
    W, m = 512, 4
    rng = np.random.default_rng(pos)
    q, k, v = _qkv(rng, (2, 8, 256), (2, W, 4, 256), torch.bfloat16, dev)
    read = min(pos, W - 1)
    pairs = [da_ops.decode_attention(q, k[:, r * 128:(r + 1) * 128], v[:, r * 128:(r + 1) * 128], read,
                                     softcap=50.0, key0=r * 128, lse=True) for r in range(m)]
    _agree(_combine(pairs).to(torch.bfloat16), da_ref.decode_attention_ref(q, k, v, read, softcap=50.0),
           torch.bfloat16)


def test_attention_wrappers_reject_bad_cuda_input(dev):
    q = torch.ones((1, 8, 2, 320), device=dev)
    with pytest.raises(ValueError, match="takes D"):
        fa_ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="takes D"):
        da_ops.decode_attention(q[:, 0], q, q, 3)
    q = torch.ones((1, 2, 64), device=dev)
    kv = torch.ones((1, 8, 2, 64), device=dev)
    with pytest.raises(ValueError, match="pos -1"):
        da_ops.decode_attention(q, kv, kv, -1)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        odd = torch.ones((1, 8, 2, 128), device=dev)[..., ::2]
        da_ops.decode_attention(q, odd, odd, 3)


def test_reduced_model_on_the_card_equals_the_host(dev):
    """Reduced gemma2 (GQA 4/2, head_dim 32, ring of 64 wrapped by a
    max_len of 96) in float32: prefill and 16 decode steps on the card
    against the same weights on the host."""
    cfg = get_config("gemma2-9b", reduced=True).replace(
        num_kv_heads=2, param_dtype="float32", compute_dtype="float32")
    host = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = LM(cfg, device=dev)
    card.load_state_dict(host.state_dict())
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)))
    lh, _ = host.forward(toks)
    lc, _ = card.forward(toks.to(dev))
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-4)
    ch, cc = decode.init_cache(host, 2, 96), decode.init_cache(card, 2, 96)
    for pos in range(56, 72):
        t = toks[:, pos % 24 : pos % 24 + 1]
        a, ch = decode.decode_step(host, t, ch, pos)
        b, cc = decode.decode_step(card, t.to(dev), cc, pos)
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    for name in ch:
        torch.testing.assert_close(cc[name].cpu(), ch[name], rtol=1e-4, atol=1e-4)


# -- §IX migration, two-level placement and the simulator on the card ----------

def _np_argmin_rows(rng, shape):
    x = rng.choice([0.0, 1.0, -1.0, np.inf, -np.inf, np.nan], size=shape,
                   p=[0.3, 0.2, 0.2, 0.1, 0.1, 0.1])
    x[:, 0] = np.where(rng.uniform(size=shape[0]) < 0.2, np.inf, x[:, 0])
    x[: shape[0] // 8] = np.inf                       # all-inf rows answer column 0
    return x


def test_reductions_on_the_card_are_numpys(dev):
    """first index on ties, the first NaN wins a minimum, argmax of an
    all-False row is 0; amin propagates NaN; stable argsort keeps ties
    in index order — on CUDA tensors, not assumed from torch."""
    from repro_torch.core import migration as PM

    rng = np.random.default_rng(0)
    for shape in ((257, 9), (64, 1030), (3, 1)):
        x = _np_argmin_rows(rng, shape)
        xt = torch.as_tensor(x, device=dev)
        assert PM.first_min_index(xt).tolist() == np.argmin(x, axis=1).tolist()
        m = rng.uniform(size=shape) < 0.1
        assert PM.first_true_index(torch.as_tensor(m, device=dev)).tolist() == \
            np.argmax(m, axis=1).tolist()
        np.testing.assert_array_equal(xt.amin(dim=1).cpu().numpy(), x.min(axis=1))
    b = np.repeat(rng.integers(0, 5, size=40).astype(float), 3)
    b[::7] = -np.inf
    got = torch.argsort(torch.as_tensor(b, device=dev), stable=True).tolist()
    assert got == np.argsort(b, kind="stable").tolist()


def test_select_peer_targets_on_the_card_equals_the_host(dev):
    from repro_torch.core import migration as PM

    rng = np.random.default_rng(1)
    for J, S in ((1, 1), (37, 13), (500, 256)):
        ja = rng.integers(0, 3, size=(J, S)).astype(float)
        cost = rng.integers(0, 3, size=(J, S)).astype(float)
        cost[rng.uniform(size=(J, S)) < 0.1] = np.inf
        cost[rng.uniform(size=(J, S)) < 0.05] = np.nan
        args = [rng.uniform(size=J) < 0.2, rng.integers(0, 4, size=J).astype(float),
                rng.choice([0.0, 1.0, np.inf, np.nan], size=J), rng.uniform(size=S) < 0.3]
        host = [torch.as_tensor(a) for a in args + [ja, cost]]
        card = [t.to(dev) for t in host]
        for a, b in zip(PM.select_peer_targets(*host), PM.select_peer_targets(*card)):
            assert a.tolist() == b.tolist()
        lazy_h = PM.select_peer_targets_lazy(*host[:5], lambda c: host[5][:, c])
        lazy_c = PM.select_peer_targets_lazy(*card[:5], lambda c: card[5][:, c])
        for a, b in zip(lazy_h, lazy_c):
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_hier_on_the_card_equals_the_host(dev):
    rng = np.random.default_rng(2)
    sites, links, jobs = _state(2, 90, 150, dead=0.2)
    tiers = {n: f"t{int(rng.integers(0, 6))}" for n in sites}
    out = {}
    for d in ("cpu", dev):
        sp = PB.SitePack.from_scheduler(sites, links, device=d)
        tp = PB.TierPack.from_site_pack(sp, tiers)
        assert tp.device.type == torch.device(d).type
        jp = PB.JobPack.from_jobs(jobs, device=d)
        sel = PB.hier_select(jp, sp, tp)
        rep = PB.hier_replay(jp, sp, tp)
        flat = PB.fused_argmin(jp, PB.SitePack.from_scheduler(sites, links, device=d))
        out[str(d)] = (sel.sites, sel.costs.tolist(), rep.sites, rep.costs.tolist(),
                       sp.queue.tolist(), sp.work.tolist(), flat.sites, flat.costs.tolist())
    host, card = out["cpu"], out[str(dev)]
    assert host == card
    assert card[0] == card[6] and card[1] == card[7]          # hier select ≡ the fused argmin


def _sim_grid(seed, n_sites):
    from repro_torch.sim import SimJob

    rng = np.random.default_rng(seed)
    names = [f"s{i:02d}" for i in range(n_sites)]
    spec = {n: int(rng.integers(1, 5)) for n in names}
    links = {(a, b): P.NetworkLink(bandwidth_Bps=float(rng.uniform(1e6, 1e8)),
                                   loss_rate=0.0 if a == b else float(rng.uniform(0.0, 0.02)),
                                   rtt_s=float(rng.uniform(0.01, 0.3)))
             for a in names for b in names}
    topo = P.GridTopology()
    for i, n in enumerate(names):
        topo.join(f"root{i % 4}", P.Node(name=n))
    jobs = [SimJob(user=("hog" if i % 5 == 0 else f"u{i % 7}"), arrival=float(i // 8) * 5.0,
                   work=float(rng.integers(10, 600)), input_bytes=float(rng.choice([0.0, 1e6, 5e9])),
                   output_bytes=float(rng.choice([0.0, 2e8])),
                   data_site=(names[i % n_sites] if i % 3 else None),
                   origin_site=names[(i * 7) % n_sites])
            for i in range(300)]
    return spec, links, topo, jobs


def _overload_sim():
    from repro_torch.sim import bench_inputs, paper_grid_spec

    return paper_grid_spec(), None, None, bench_inputs.overload_workload()


@pytest.mark.parametrize("placement", ["flat", "hier"])
@pytest.mark.parametrize("workload", ["overload", "tiered"])
def test_gridsim_on_the_card_equals_the_host(dev, workload, placement):
    from repro_torch.sim import GridSim, SimConfig

    spec, links, topo, jobs = _overload_sim() if workload == "overload" else _sim_grid(7, 24)
    traces = []
    for d in ("cpu", dev):
        cfg = SimConfig(policy="diana", quotas={"hog": 10.0, "polite": 1000.0},
                        migration_interval_s=30.0, congestion_window_s=120.0,
                        placement=placement, topology=topo)
        sim = GridSim(dict(spec), links=None if links is None else dict(links), config=cfg, device=d)
        res = sim.run(copy.deepcopy(jobs))
        traces.append(([(j.exec_site, j.start, j.finish, j.migrated) for j in res.jobs],
                       res.timeline))
    assert traces[0] == traces[1]
    assert sum(m for *_, m in traces[1][0]) > 0


def test_peer_api_on_the_card_equals_the_host(dev):
    """PeerScheduler's select (the fused f64 argmin), rank (the f64
    plane) and place on the card against the host, and single-peer ≡
    DianaScheduler."""
    sites, links, jobs = _state(17, 60, 300)
    out = {}
    for d in ("cpu", dev):
        peer = P.single_peer(copy.deepcopy(sites), dict(links), device=d)
        before = (cm_ops.cost_argmin_f64.launches, cm_ops.cost_matrix_f64.launches)
        sel = peer.select_sites_batch(jobs)
        rank = peer.rank_sites_batch(jobs[:50])
        pl = peer.place_batch(copy.deepcopy(jobs))
        if d != "cpu":
            assert cm_ops.cost_argmin_f64.launches > before[0]
            assert cm_ops.cost_matrix_f64.launches > before[1]
        diana = P.DianaScheduler(copy.deepcopy(sites), dict(links), device=d)
        dpl = diana.place_batch(copy.deepcopy(jobs))
        assert (pl.sites, pl.costs.tolist()) == (dpl.sites, dpl.costs.tolist())
        out[str(d)] = (sel.sites, sel.costs.tolist(), rank, pl.sites, pl.costs.tolist(),
                       [(s.queue_length, s.waiting_work) for s in peer.authoritative.values()])
    assert out["cpu"] == out[str(dev)]


@pytest.mark.parametrize("wire,lossy", [("delta", False), ("full", False), ("delta", True)])
def test_p2p_gridsim_on_the_card_equals_the_host(dev, wire, lossy):
    from repro_torch.sim import P2PGridSim, SimConfig, TransportFaults, bench_inputs

    nodes = bench_inputs.p2p_grid(24)
    jobs = bench_inputs.p2p_workload(sorted(nodes), 400)
    tf = TransportFaults(seed=3, loss=0.15, duplicate=0.05, reorder_jitter_s=8.0,
                         corrupt=0.02) if lossy else None
    runs = []
    for d in ("cpu", dev):
        cfg = SimConfig(policy="diana", num_peers=4, exchange_interval_s=30.0,
                        exchange_latency_s=2.0, gossip_wire=wire, transport_faults=tf,
                        quotas={"u0": 10.0}, migration_interval_s=30.0, congestion_window_s=120.0)
        sim = P2PGridSim(nodes, config=cfg, device=d)
        res = sim.run(copy.deepcopy(jobs))
        runs.append(([(j.exec_site, j.start, j.finish, j.migrated) for j in res.jobs],
                     res.timeline, sim.exchange.stats.as_dict(),
                     [(p.version.tolist(), p.stamp.tolist(), p.view.queue.tolist())
                      for p in sim.peers]))
    assert runs[0] == runs[1]
    assert runs[1][2]["rounds"] > 0


# -- the hybrid, ssm, vlm and encdec families on the card ------------------------


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-780m", "llama-3.2-vision-11b", "whisper-base"])
def test_reduced_family_on_the_card_equals_the_host(dev, arch):
    """Each family reduced, in float32 (window 8 and chunk 8 as the
    reference's oracle sets them; vision at two periods of five layers,
    cross gates 0.5): prefill and 16 decode steps on the card against the
    same weights on the host, and every cache after them."""
    kw = dict(param_dtype="float32", compute_dtype="float32", local_window=8, ssm_chunk=8)
    if arch.startswith("llama"):
        kw["num_layers"] = 10
    cfg = get_config(arch, reduced=True).replace(**kw)
    host = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for blocks in (getattr(host, "cross_blocks", ()), getattr(host, "dec_cross", ())):
        for b in blocks:
            b.xgate.fill_(0.5)
    card = LM(cfg, device=dev)
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)))
    extra = {}
    if cfg.family == "vlm":
        extra["image_embeds"] = torch.as_tensor(rng.standard_normal((2, 16, cfg.d_model)) * 0.1, dtype=torch.float32)
    if cfg.family == "encdec":
        extra["audio_embeds"] = torch.as_tensor(rng.standard_normal((2, 64, cfg.d_model)) * 0.1, dtype=torch.float32)
    on_card = {k: v.to(dev) for k, v in extra.items()}
    before = (fa_ops.flash_attention.launches, da_ops.decode_attention.launches)
    lh, _ = host.forward(toks, **extra)
    lc, _ = card.forward(toks.to(dev), **on_card)
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-4)
    ch, cc = decode.init_cache(host, 2, 24, **extra), decode.init_cache(card, 2, 24, **on_card)
    for pos in range(16):
        a, ch = decode.decode_step(host, toks[:, pos : pos + 1], ch, pos)
        b, cc = decode.decode_step(card, toks[:, pos : pos + 1].to(dev), cc, pos)
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    for name in ch:
        torch.testing.assert_close(cc[name].cpu(), ch[name], rtol=1e-4, atol=1e-4)
    launched = (fa_ops.flash_attention.launches - before[0], da_ops.decode_attention.launches - before[1])
    if cfg.family == "ssm":
        assert launched == (0, 0)          # the SSD path has no kernel
    else:
        assert min(launched) > 0


# -- the moe family on the card ---------------------------------------------------


def _moe_pair(dev, arch, dtype="float32", **kw):
    cfg = get_config(arch, reduced=True).replace(param_dtype=dtype, compute_dtype=dtype, **kw)
    host = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    if cfg.router == "sigmoid":
        for b in host.moe_blocks:
            b.moe.router_bias.copy_(torch.linspace(-0.05, 0.05, cfg.num_experts))
    card = LM(cfg, device=dev)
    card.load_state_dict(host.state_dict())
    return cfg, host, card


@pytest.mark.parametrize("cf", [1.25, 0.3])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_moe_layer_and_mla_decode_on_the_card_equal_the_host(dev, arch, cf):
    """One MoE layer (dropping tokens at cf 0.3) and 12 absorbed-form MLA
    decode steps with their latent caches, float32, card against host."""
    from repro_torch.models.mla import init_mla_cache, mla_decode
    from repro_torch.models.moe import moe_layer

    cfg, host, card = _moe_pair(dev, arch, capacity_factor=cf)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 40, cfg.d_model)), dtype=torch.float32)
    yh, ah = moe_layer(host.moe_blocks[0].moe, x, cfg)
    yc, ac = moe_layer(card.moe_blocks[0].moe, x.to(dev), cfg)
    torch.testing.assert_close(yc.cpu(), yh, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ac.cpu(), ah, rtol=1e-5, atol=1e-7)
    ch = {k: v[0] for k, v in init_mla_cache(cfg, 2, 16, 1).items()}
    cc = {k: v[0] for k, v in init_mla_cache(cfg, 2, 16, 1, device=dev).items()}
    for pos in range(12):
        xt = x[:, pos : pos + 1]
        oh, _, _ = mla_decode(host.moe_blocks[1].attn, xt, ch["c_kv"], ch["k_rope"], pos, cfg)
        oc, _, _ = mla_decode(card.moe_blocks[1].attn, xt.to(dev), cc["c_kv"], cc["k_rope"], pos, cfg)
        torch.testing.assert_close(oc.cpu(), oh, rtol=1e-4, atol=1e-4)
        for k in ch:
            torch.testing.assert_close(cc[k].cpu(), ch[k], rtol=1e-5, atol=1e-5)


MLA_WIDTHS = {"published": dict(qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128), "reduced": {}}


@pytest.mark.parametrize("widths", sorted(MLA_WIDTHS))
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_reduced_moe_model_on_the_card_equals_the_host(dev, arch, widths):
    """Reduced deepseek, float32, at the published MLA head widths (nope
    128, rope 64, v 128: the flash kernel's (192, 128) instance) and at
    the reduced config's own (48, 32), which take the padded route to
    (64, 64): prefill (flash kernel) and 12 decode steps on the card
    against the host, and both latent caches."""
    cfg, host, card = _moe_pair(dev, arch, **MLA_WIDTHS[widths])
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12)))
    before = fa_ops.flash_attention.launches, fa_ops.flash_attention.padded
    (lh, ah), (lc, ac) = host.forward(toks), card.forward(toks.to(dev))
    assert fa_ops.flash_attention.launches == before[0] + cfg.num_layers
    assert fa_ops.flash_attention.padded == before[1] + (cfg.num_layers if widths == "reduced" else 0)
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ac.cpu(), ah, rtol=1e-5, atol=1e-7)
    ch, cc = decode.init_cache(host, 2, 16), decode.init_cache(card, 2, 16)
    for pos in range(12):
        a, ch = decode.decode_step(host, toks[:, pos : pos + 1], ch, pos)
        b, cc = decode.decode_step(card, toks[:, pos : pos + 1].to(dev), cc, pos)
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    for g in ch:
        for k in ch[g]:
            torch.testing.assert_close(cc[g][k].cpu(), ch[g][k], rtol=1e-4, atol=1e-4)


# -- flash attention's backward kernel and training on the card -----------------

# (B, Sq, Sk, H, KV, D, Dv, causal, window, softcap): every (D, Dv)
# instance, GQA rep 1/2/3/10/16, ragged lengths, window edges inside a
# tile, Sq < Sk and Sq > Sk non-causal, soft-cap 0 and 50, and a window
# of 1 (each row sees only itself: dq and dk are zero but for rounding).
FLASH_BWD_CASES = [
    (1, 77, 77, 4, 2, 32, 32, True, 0, 0.0),
    (2, 200, 200, 6, 2, 64, 64, True, 50, 50.0),
    (1, 1000, 1000, 10, 1, 256, 256, True, 333, 50.0),
    (1, 77, 200, 16, 1, 128, 128, False, 0, 0.0),
    (2, 130, 130, 3, 1, 256, 256, True, 45, 30.0),
    (1, 200, 200, 8, 8, 192, 128, True, 0, 0.0),
    (1, 1000, 1000, 16, 16, 192, 128, False, 0, 0.0),
    (2, 64, 64, 2, 2, 128, 128, True, 2, 50.0),
    (2, 64, 64, 2, 2, 32, 32, True, 1, 50.0),
    (2, 200, 77, 8, 2, 128, 128, False, 0, 0.0),
    (1, 1024, 1024, 64, 64, 192, 128, True, 0, 0.0),    # a rank's MLA heads under the 2 × 2 mesh (smoke phase 15)
]
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _grads_agree(got, want, dtype, floor=0.0):
    """Each of dq, dk, dv: max |diff| ≤ tol · max(max |plain|, floor) (f32
    1e-4, bf16 2e-2; ``floor`` a tenth of the call's largest gradient for a
    window of 1, as tests/test_torch_flash_bwd.py holds it), and in bf16,
    where the floor does not bind, the mean error under 1% of the mean
    |plain|."""
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape, name
        err, big = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
        assert err <= BWD_TOL[dtype] * max(big, floor), f"{name}: {err}"
        if dtype == torch.bfloat16 and big >= floor:
            assert float((a.float() - b.float()).abs().mean()) < 0.01 * float(b.float().abs().mean()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=str)
def test_flash_attention_backward_kernel(dev, case, dtype):
    B, Sq, Sk, H, KV, D, Dv, causal, window, cap = case
    rng = np.random.default_rng(Sq * 3 + D + H)
    q = _randn(rng, (B, Sq, H, D), dtype, dev, 1.5)
    kv = torch.cat([_randn(rng, (B, Sk, KV, D), dtype, dev, 1.5), _randn(rng, (B, Sk, KV, Dv), dtype, dev)], -1)
    k, v = kv[..., :D], kv[..., D:]          # one buffer, as MLA's (and the strides the kernel reads)
    do = _randn(rng, (B, Sq, H, Dv), dtype, dev)
    o, lse = fa_ops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap, return_lse=True)
    before = fa_ops.flash_attention_bwd.launches, fa_ops.flash_attention_bwd.by_pair.get((D, Dv), 0)
    got = fa_ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, softcap=cap, lse=lse)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_bwd.launches == before[0] + 1
    assert fa_ops.flash_attention_bwd.by_pair[(D, Dv)] == before[1] + 1
    want = fa_ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window, softcap=cap)
    _grads_agree(got, want, dtype, 0.1 * max(float(w.float().abs().max()) for w in want) if window == 1 else 0.0)
    again = fa_ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, softcap=cap, lse=lse)
    for a, b in zip(got, again):          # no atomics: the same bits every run
        assert torch.equal(a, b)


def test_flash_attention_autograd_launches_both_kernels(dev):
    rng = np.random.default_rng(5)
    q, k, v = (t.requires_grad_() for t in _qkv(rng, (1, 300, 8, 128), (1, 300, 4, 128), torch.bfloat16, dev))
    do = _randn(rng, (1, 300, 8, 128), torch.bfloat16, dev)
    before = fa_ops.flash_attention.launches, fa_ops.flash_attention_bwd.launches
    o = fa_ops.flash_attention(q, k, v, window=100, softcap=50.0)
    o.backward(do)
    torch.cuda.synchronize()
    assert (fa_ops.flash_attention.launches, fa_ops.flash_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = fa_ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), do, window=100,
                                          softcap=50.0)
    _grads_agree((q.grad, k.grad, v.grad), want, torch.bfloat16)


def test_flash_attention_kernels_from_a_fresh_host_thread(dev):
    """The forward and backward as the first CUDA work of a new host
    thread (an autograd worker's first node is one): the entries make the
    device's context current before the driver encodes their tensor maps."""
    import threading

    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, (1, 300, 8, 128), (1, 300, 4, 128), torch.bfloat16, dev)
    do = _randn(rng, (1, 300, 8, 128), torch.bfloat16, dev)
    want_o = fa_ref.flash_attention_ref(q, k, v, window=100, softcap=50.0)
    out, errors = {}, []

    def run():
        try:
            o, lse = fa_ops.flash_attention(q, k, v, window=100, softcap=50.0, return_lse=True)
            out["o"] = o
            out["g"] = fa_ops.flash_attention_bwd(q, k, v, o, do, window=100, softcap=50.0, lse=lse)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 (reported below, on the test's thread)
            errors.append(e)

    for _ in range(2):
        th = threading.Thread(target=run)
        th.start()
        th.join()
        assert not errors, errors
        _agree(out["o"], want_o, torch.bfloat16)
        _grads_agree(out["g"], fa_ref.flash_attention_bwd_ref(q, k, v, out["o"], do, window=100, softcap=50.0),
                     torch.bfloat16)


def test_flash_attention_backward_refuses_what_it_cannot_take(dev):
    q = torch.ones((1, 8, 2, 320), device=dev)
    o = torch.ones((1, 8, 2, 320), device=dev)
    with pytest.raises(ValueError, match="takes D"):
        fa_ops.flash_attention_bwd(q, q, q, o, o)
    with pytest.raises(ValueError, match="do must be"):
        fa_ops.flash_attention_bwd(q[..., :64], q[..., :64], q[..., :64], o[..., :64], o[..., :32])
    q64, o64 = q[..., :64].contiguous(), o[..., :64].contiguous()
    with pytest.raises(ValueError, match="lse must be"):              # the card's kernels take P from it
        fa_ops.flash_attention_bwd(q64, q64, q64, o64, o64)
    with pytest.raises(ValueError, match="lse must be"):
        fa_ops.flash_attention_bwd(q64, q64, q64, o64, o64, lse=torch.zeros((1, 2, 7), device=dev))


def test_reduced_training_on_the_card_equals_the_host(dev):
    """Reduced gemma2 (D 32, GQA 4/2, the window cut to 8) in float32, 3
    train steps with remat on: the card (flash forward and backward
    kernels) against the same steps on the host."""
    from repro_torch.runtime import TrainConfig, build_train_step, init_opt_state
    from repro_torch.data import SyntheticLMDataset

    cfg = get_config("gemma2-9b", reduced=True).replace(
        num_kv_heads=2, local_window=8, remat=True, param_dtype="float32", compute_dtype="float32")
    host = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = LM(cfg, device=dev)
    card.load_state_dict(host.state_dict())
    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    steps = {m: build_train_step(m, tcfg) for m in (host, card)}
    opts = {m: init_opt_state(m) for m in (host, card)}
    ds = SyntheticLMDataset(cfg.vocab_size, 48, seed=1)
    before = fa_ops.flash_attention.launches, fa_ops.flash_attention_bwd.launches
    for s in range(3):
        b = ds.batch(s, 2)
        mh, mc = steps[host](opts[host], b), steps[card](opts[card], b)
        torch.testing.assert_close(mc["loss"].cpu(), mh["loss"], rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert fa_ops.flash_attention.launches - before[0] == 3 * 2 * L      # forward + remat recompute
    assert fa_ops.flash_attention_bwd.launches - before[1] == 3 * L
    for (name, a), (_, b) in zip(card.named_parameters(), host.named_parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0, atol=1e-4 * float(b.abs().max()), msg=name)



# -- the sharded training step on the card -------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("window", [0, 4096])
def test_sharded_attention_local_heads_on_the_card(dev, window, dtype):
    """What a rank of a 2 × 2 mesh runs in gemma2-9b's sharded attention
    (``chip_smoke.py`` phase 13): its 8 of 16 query heads and 4 of 8 kv
    heads (GQA's rep 2 kept), D 256, soft-cap 50, one row of 2,048 tokens,
    a global and a local layer (window 4,096), through ``FlashAttentionFn``:
    the forward and backward kernels, once each, against the plain
    versions."""
    rng = np.random.default_rng(13 + window)
    q, k, v = (t.requires_grad_() for t in _qkv(rng, (1, 2048, 8, 256), (1, 2048, 4, 256), dtype, dev))
    do = _randn(rng, (1, 2048, 8, 256), dtype, dev)
    before = fa_ops.flash_attention.launches, fa_ops.flash_attention_bwd.launches
    o = fa_ops.flash_attention(q, k, v, window=window, softcap=50.0)
    o.backward(do)
    torch.cuda.synchronize()
    assert (fa_ops.flash_attention.launches, fa_ops.flash_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    _agree(o.detach(), fa_ref.flash_attention_ref(q.detach(), k.detach(), v.detach(), window=window, softcap=50.0),
           dtype)
    want = fa_ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), do, window=window,
                                          softcap=50.0)
    _grads_agree((q.grad, k.grad, v.grad), want, dtype)


@pytest.mark.parametrize("arch", ["gemma2-9b", "recurrentgemma-2b", "llama-3.2-vision-11b", "whisper-base"])
def test_sharded_train_step_on_the_card_equals_one_process(dev, arch):
    """Four ranks of a 2 × 2 mesh on the one card (gloo), each family's
    reduced model in float32 with remat (``_torch_sharded_train_ranks
    .CARD_CFG``, the cross gates at 0.5): 3 sharded steps against the
    one-process step on the card from the same parameters and data
    (``tests/_torch_sharded_train_ranks.card_step``): loss and grad norm
    within 1e-5 relative, the learning rate equal, every parameter block
    within the CPU test's limits in units of its leaf's largest change
    (``ranks.assert_within_change``), and every rank through the flash
    kernels."""
    import json

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.runtime import sharding

    import _torch_sharded_train_ranks as ranks

    want = ranks.card_step(None, arch)            # builds the library before any rank starts
    mesh = {"data": 2, "model": 2}
    L = ranks.sharded_layers(get_config(arch, reduced=True).replace(**ranks.CARD_CFG[arch]))[0]
    for r in run_ranks(ranks.card_step, mesh, backend="gloo", args=(arch,), timeout=600):
        coords = dict(zip(mesh, (int(c) for c in r["coords"])))
        got = r["metrics"]
        np.testing.assert_allclose(got[:, :2], want["metrics"][:, :2], rtol=1e-5, atol=0)
        np.testing.assert_array_equal(got[:, 2], want["metrics"][:, 2])
        assert r["launches"].tolist() == [2 * L * 3, L * 3]           # remat: two forwards a layer a step
        for name, spec in json.loads(str(r["specs"])).items():
            spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
            whole = torch.from_numpy(want["params"][name])
            block = sharding.local_block(whole, spec, mesh, coords).numpy()
            change = float(np.abs(want["params"][name] - want["before"][name]).max())
            ranks.assert_within_change(r["params"][name], block, change, "adamw", f"{name} at {coords}")


@pytest.mark.parametrize("kind", ["rglru", "cross", "mla", "mamba", "moe_gather"])
def test_sharded_layer_on_four_ranks_equals_one_process(dev, kind):
    """Four ranks of a 2 × 2 mesh on the one card, float32 at published
    width (``_torch_sharded_train_ranks.card_layer``): recurrentgemma-2b's
    RG-LRU block (``rglru_sharded``: 1,280 of 2,560 channels a rank, the xw
    gather over 'model'), llama-3.2-vision-11b's cross attention over
    1,601 image tokens (``attention_sharded``, non-causal, 16 heads and 4
    kv heads a rank through the (128, 128) flash kernels, forward and
    backward), deepseek-v2-236b's MLA (``mla_sharded``: 64 of 128 heads a
    rank through the (192, 128) kernels, forward and backward),
    mamba2-780m's SSD block (``mamba_sharded``: 24 of 48 heads a rank) or
    deepseek-v2-236b's moe layer with 16 of its 160 experts
    (``moe_sharded``: the gather dispatch of the sharded batch at the
    capacity factor 1.25, dropping tokens, against the one-process
    ``_moe_gather``). Each rank's output rows and its blocks' gradients
    (summed over the axes a block is replicated on) against the
    one-process layer's, within 1e-4 of the largest |value|."""
    import json

    from repro_torch.launch.mesh import run_ranks
    from repro_torch.runtime import sharding

    import _torch_sharded_train_ranks as ranks

    want = ranks.card_layer(None, kind)           # builds the library before any rank starts
    mesh = {"data": 2, "model": 2}
    rows = ("data", None, None)
    for r in run_ranks(ranks.card_layer, mesh, backend="gloo", args=(kind,), timeout=600):
        coords = dict(zip(mesh, (int(c) for c in r["coords"])))
        y = sharding.local_block(torch.from_numpy(want["y"]), rows, mesh, coords).numpy()
        np.testing.assert_allclose(r["y"], y, rtol=0, atol=1e-4 * np.abs(y).max(), err_msg=str(coords))
        for name, spec in json.loads(str(r["specs"])).items():
            spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
            g = sharding.local_block(torch.from_numpy(want["grads"][name]), spec, mesh, coords).numpy()
            np.testing.assert_allclose(r["grads"][name], g, rtol=0, atol=1e-4 * np.abs(g).max(),
                                       err_msg=f"{name} at {coords}")
        pairs = (json.loads(str(r["pairs"])), json.loads(str(r["bwd_pairs"])))
        pair = {"cross": "128x128", "mla": "192x128"}.get(kind)
        assert pairs == (({pair: 1}, {pair: 1}) if pair else ({}, {})), pairs
        if kind == "moe_gather":
            assert int(r["dropped"]) == int(want["dropped"]) > 0


def test_vocab_parallel_lookup_and_chunk_on_two_ranks(dev):
    """Two ranks of a 1 × 2 mesh on the one card over gloo
    (``tests/_torch_vocab_ranks.py``, as ``tests/test_torch_vocab_parallel.py``
    runs them on the host): the vocab-parallel lookup equal to
    ``F.embedding`` on the whole table bit for bit (float32 and bfloat16)
    and its block's gradient within 1e-6; a loss chunk's sums within 1e-6
    relative of one process's and its gradients within 1e-6, with and
    without soft-cap, the labels −1, vocab_size, a padded id and the
    blocks' edges among them; CUDA tensors."""
    from repro_torch.launch.mesh import run_ranks

    import _torch_vocab_ranks as ranks

    cases = ["lookup/float32", "lookup/bfloat16", "chunk/0.0/0.0001", "chunk/30.0/0.0001"]
    for r in run_ranks(ranks.run, {"data": 1, "model": 2}, backend="gloo", args=(cases,), timeout=600):
        assert r["device"].startswith("cuda"), r["device"]
        for case in cases:
            if case.startswith("lookup"):
                ranks.assert_lookup(r["coords"], r[case], case.split("/")[1])
            else:
                ranks.assert_chunk(r["coords"], r[case])


def test_serving_zero3_decode_and_prefill_on_four_ranks(dev):
    """Four ranks of a 2 × 2 mesh on the one card over gloo, serving's ZeRO
    forced (``tests/_torch_vocab_ranks.py``'s ``zero3``, as
    ``tests/test_torch_vocab_parallel.py`` runs it on the host): reduced
    gemma2-9b's decode steps and prefill with the tables cut over
    ('model', 'data'), the weight-stationary lookup and logits, within
    1e-5 of one process's largest logit; CUDA tensors."""
    from repro_torch.launch.mesh import run_ranks

    import _torch_vocab_ranks as ranks

    for r in run_ranks(ranks.run, {"data": 2, "model": 2}, backend="gloo", args=(["zero3"],), timeout=600):
        assert r["device"].startswith("cuda"), r["device"]
        ranks.assert_zero3(r["coords"], r["zero3"])


# -- the meta route, the serve step and the smoke's bounds on the card --------------

def _work_of(fn):
    from repro_torch.launch.op_analysis import OpAnalysis

    with OpAnalysis() as mode:
        fn()
    return mode.cost.by_kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("D,Dv", [(32, 32), (64, 64), (128, 128), (256, 256), (192, 128), (48, 32), (80, 80)])
def test_meta_and_kernel_routes_charge_equal_work(dev, D, Dv, dtype):
    """Flash forward (with and without lse) and backward, then the decode
    kernel at D: the same calls, FLOPs and bytes charged on the card as on
    meta, and launches only on the card."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops

    B, Sq, Sk, H, KV = 2, 77, 200, 6, 3
    out = {}
    for device in (dev, torch.device("meta")):
        gen = torch.Generator().manual_seed(0)
        draw = lambda *s: torch.randn(s, generator=gen).to(dtype).to(device)  # noqa: E731
        kv = draw(B, Sk, KV, D + Dv)
        q, k, v = draw(B, Sq, H, D), kv[..., :D], kv[..., D:]
        n0 = fa_ops.flash_attention.launches + fa_ops.flash_attention_bwd.launches + da_ops.decode_attention.launches

        def run():
            fa_ops.flash_attention(q, k, v, causal=False, softcap=30.0)
            o, lse = fa_ops.flash_attention(q, k, v, window=64, return_lse=True)
            fa_ops.flash_attention_bwd(q, k, v, o, o, window=64, lse=lse)
            da_ops.decode_attention(draw(B, H, D), draw(B, Sk, KV, D), draw(B, Sk, KV, D), 150, window=100)

        out[device.type] = _work_of(run)
        n1 = fa_ops.flash_attention.launches + fa_ops.flash_attention_bwd.launches + da_ops.decode_attention.launches
        assert n1 - n0 == (4 if device.type == "cuda" else 0)
    assert out["cuda"] == out["meta"]


def test_serve_step_on_the_card_is_decode_step(dev):
    import copy as _copy

    from repro_torch.configs import get_config
    from repro_torch.models import LM, decode
    from repro_torch.runtime.serve import build_serve_step

    cfg = get_config("gemma2-9b", reduced=True)
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    B, max_len = 3, 40
    step, cache_abs = build_serve_step(lm, B, max_len)
    cache = decode.init_cache(lm, B, max_len)
    assert {k: (v.shape, v.dtype) for k, v in cache_abs.items()} == {k: (v.shape, v.dtype) for k, v in cache.items()}
    twin = _copy.deepcopy(cache)
    rng = np.random.default_rng(0)
    for pos in list(range(5)) + [max_len - 1]:
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32), device=dev)
        got, cache = step(tok, cache, pos)
        want, twin = decode.decode_step(lm, tok, twin, pos)
        assert torch.equal(got, want)


def test_smoke_bounds_are_unchanged_on_the_card(dev):
    """chip_smoke.py's timed shapes, their (bytes, operations) as the smoke
    counted them before the move into the kernels' work functions."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    pairs = fa_ops.visible_pairs
    B, S_, H, KV, D = (cs.PREFILL[k] for k in ("B", "S", "H", "KV", "D"))
    for window in (0, 4096):
        f, b = fa_ops.work(B, S_, S_, H, KV, D, D, window=window)
        assert cs.bound(b, f, "bf16") == cs.bound((2 * B * S_ * H * D + 2 * B * S_ * KV * D) * 2,
                                                  4 * B * H * D * pairs(S_, S_, True, window), "bf16")
        f, b = fa_ops.bwd_work(B, S_, S_, H, KV, D, D, window=window)
        assert cs.bound(b, f, "bf16") == cs.bound((4 * B * S_ * H * D + 4 * B * S_ * KV * D) * 2,
                                                  2 * (3 * D + 2 * D) * H * pairs(S_, S_, True, window) * B, "bf16")
    B, S_, H, DQK, DV = (cs.MLA_ROW[k] for k in ("B", "S", "H", "DQK", "DV"))
    f, b = fa_ops.work(B, S_, S_, H, H, DQK, DV)
    assert cs.bound(b, f, "bf16") == cs.bound(2 * B * S_ * H * (DQK + DV) * 2,
                                              2 * B * H * pairs(S_, S_, True, 0) * (DQK + DV), "bf16")
    for c in cs.DECODE_ROWS.values():
        f, b = da_ops.work(c["B"], c["H"], c["KV"], c["D"], c["pos"])
        v = c["pos"] + 1
        old = (2 * c["B"] * v * c["KV"] * c["D"] * 2 + 2 * c["B"] * c["H"] * c["D"] * 2,
               4 * c["B"] * c["H"] * c["D"] * v)
        assert cs.bound(b, f, "bf16") == cs.bound(*old, "bf16")
