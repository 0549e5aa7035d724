"""The decode kernel's key-range entry (``key0``, ``lse=True``), on the CPU
through its plain version.

A cache cut into m ranges of equal length, each range's (out, lse) pair
from ``decode_attention(..., key0=start, lse=True)``, combined by the rule
the sharded decode uses (M = max lse, w = e^(lse − M), out = Σ w·out / Σ w),
equals the whole-cache ``decode_attention`` at the JAX kernel tests'
tolerances (2e-5 float32, 2e-2 bfloat16), for m ∈ {2, 4, 8}, GQA rep 1, 2
and 10, windows that cut a range, positions before which whole ranges see
no key, and the ring's pos' = min(pos, W − 1). A range that sees no key
gives out 0 and lse −inf, never a NaN; ``ops.work`` charges exactly the
keys a range shows. The float32 whole-cache result is also held against
the JAX oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref
from repro_torch.kernels.decode_attention import ops as da_ops

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _inputs(B, S, H, KV, D, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32) * 1.5
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32) * 1.5
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    return q, k, v, *(torch.from_numpy(a).to(dtype) for a in (q, k, v))


def combine(pairs):
    """The ranks' combine of (out, lse) pairs, as decode_attention_sharded does it."""
    outs = torch.stack([o for o, _ in pairs])
    lses = torch.stack([m for _, m in pairs])
    M = lses.amax(0)
    M = torch.where(torch.isfinite(M), M, torch.zeros_like(M))
    w = torch.exp(lses - M)
    return (w[..., None] * outs).sum(0) / w.sum(0)[..., None]


def ranged(q, k, v, pos, m, **kw):
    S = k.shape[1]
    n = S // m
    return [da_ops.decode_attention(q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n], pos, key0=r * n, lse=True,
                                    **kw) for r in range(m)]


CASES = [
    # (B, S, H, KV, D, pos, window, softcap)
    (2, 512, 4, 4, 32, 511, 0, 50.0),        # rep 1, every range full
    (2, 512, 8, 4, 64, 200, 0, 0.0),         # rep 2, ranges past pos see nothing
    (1, 1024, 10, 1, 128, 700, 300, 0.0),    # rep 10 over one kv head, a window cutting a range
    (3, 256, 16, 8, 32, 0, 0, 50.0),         # only key 0 visible
    (2, 2048, 16, 8, 256, 1500, 4096, 50.0),  # gemma2's widths, a window past the cache
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_ranges_combined_equal_the_whole_cache(case, m, dtype):
    B, S, H, KV, D, pos, window, cap = case
    *_, q, k, v = _inputs(B, S, H, KV, D, dtype, seed=S + pos + m)
    kw = dict(window=window, softcap=cap)
    pairs = ranged(q, k, v, pos, m, **kw)
    for o, lse in pairs:
        assert o.dtype == torch.float32 and lse.dtype == torch.float32
        assert tuple(o.shape) == (B, H, D) and tuple(lse.shape) == (B, H)
        assert not torch.isnan(o).any() and not torch.isnan(lse).any()
    got = combine(pairs)
    want = da_ops.decode_attention(q, k, v, pos, **kw)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.to(dtype).float().numpy(), want.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_ranges_combined_equal_the_jax_oracle(case):
    B, S, H, KV, D, pos, window, cap = case
    qn, kn, vn, q, k, v = _inputs(B, S, H, KV, D, torch.float32, seed=S + pos)
    want = jax_decode_ref(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), pos, window=window, softcap=cap)
    got = combine(ranged(q, k, v, pos, 4, window=window, softcap=cap))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("key0,pos,window", [(256, 100, 0), (256, 255, 0), (0, 900, 100), (128, 900, 500)])
def test_a_range_that_sees_no_key(key0, pos, window, dtype):
    """Wholly past pos, or wholly before the window: out 0, lse −inf."""
    *_, q, k, v = _inputs(2, 256, 8, 2, 64, dtype, seed=key0 + pos)
    out, lse = da_ops.decode_attention(q, k, v, pos, key0=key0, window=window, softcap=50.0, lse=True)
    assert da_ops.visible_keys(pos, window=window, key0=key0, S=256) == 0
    assert torch.equal(out, torch.zeros_like(out))
    assert bool((lse == float("-inf")).all())
    plain = da_ops.decode_attention(q, k, v, pos, key0=key0, window=window, softcap=50.0)
    assert torch.equal(plain, torch.zeros_like(plain))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 3, 510, 511, 512, 513, 600, 4095])
def test_ring_ranges_read_to_min_pos_w(pos, dtype):
    """A ring of W slots cut into 4 ranges: each range read to
    pos' = min(pos, W − 1) with no window equals the whole ring read so."""
    W, m = 512, 4
    *_, q, k, v = _inputs(2, W, 8, 4, 32, dtype, seed=pos)
    read = min(pos, W - 1)
    got = combine(ranged(q, k, v, read, m, softcap=50.0))
    want = da_ops.decode_attention(q, k, v, read, softcap=50.0)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.to(dtype).float().numpy(), want.float().numpy(), rtol=tol, atol=tol)


def test_lse_is_the_log_sum_exp_of_the_visible_scores():
    B, S, H, KV, D, pos, window, cap = 2, 96, 4, 2, 32, 80, 50, 50.0
    *_, q, k, v = _inputs(B, S, H, KV, D, torch.float32, seed=7)
    key0 = 10
    _, lse = da_ops.decode_attention(q, k, v, pos, key0=key0, window=window, softcap=cap, lse=True)
    qg = q.reshape(B, KV, H // KV, D).double()
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k.double()) * D ** -0.5
    s = cap * torch.tanh(s / cap)
    kp = key0 + torch.arange(S)
    keep = (kp <= pos) & (pos - kp < window)
    want = torch.logsumexp(s[..., keep], dim=-1).reshape(B, H)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pos,window,key0,S", [(100, 0, 0, None), (100, 30, 0, None), (100, 0, 64, 32),
                                               (100, 0, 80, 32), (100, 0, 101, 32), (100, 50, 0, 40),
                                               (100, 50, 60, 64), (5, 0, 0, 4096)])
def test_work_charges_the_visible_keys(pos, window, key0, S):
    n = S if S is not None else pos + 1
    kp = key0 + np.arange(n)
    vis = (kp <= pos) & ((pos - kp < window) if window else True)
    assert da_ops.visible_keys(pos, window=window, key0=key0, S=S) == int(vis.sum())
    B, H, KV, D = 2, 8, 4, 64
    f, b = da_ops.work(B, H, KV, D, pos, window=window, key0=key0, S=S, lse=True)
    assert f == 4 * B * H * D * int(vis.sum())
    assert b == (2 * B * int(vis.sum()) * KV * D + B * H * D) * 2 + B * H * (D + 1) * 4


def test_wrapper_refuses_negative_positions():
    q, k = torch.ones((1, 2, 32)), torch.ones((1, 8, 2, 32))
    with pytest.raises(ValueError, match="pos -1"):
        da_ops.decode_attention(q, k, k, -1)
    with pytest.raises(ValueError, match="key0 -8"):
        da_ops.decode_attention(q, k, k, 3, key0=-8, lse=True)
