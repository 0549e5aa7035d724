"""The attention kernels' plain versions against the reference, on the CPU.

Each plain version (``repro_torch.kernels.*.ref``) is held against the
JAX Pallas kernel in interpret mode on the JAX kernel tests' own cases
and tolerances (2e-5 float32, 2e-2 bfloat16), flash against the
reference model's chunked online-softmax path, and the port's ring
decode against the reference ``_ring_decode`` as the position crosses
the ring's size. Inputs are drawn with NumPy and handed to both; the
spread cases draw q and k with a standard deviation of 1.5, so scores
spread over several units as a trained model's do and a wrong rescale
between key blocks moves the output far past the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.decode_attention.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.models import LM as RefLM
from repro.models.attention import _chunked, _sdpa
from repro.models.decode import _ring_decode as ref_ring_decode
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import LM, params_from_reference
from repro_torch.models.attention import decode_attention
from repro_torch.models.interop import tensor_from_numpy
from test_torch_models import warm_cpu_math

warm_cpu_math()

# tests/kernels/test_kernels.py:60-68 and :111-118, with the types as names.
ATTN_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, softcap, dtype)
    (1, 128, 128, 4, 4, 64, True, 0, 0.0, "float32"),
    (2, 256, 256, 4, 2, 64, True, 0, 0.0, "float32"),
    (1, 128, 128, 8, 1, 128, True, 64, 0.0, "float32"),    # MQA + window
    (1, 256, 256, 4, 4, 128, True, 0, 50.0, "float32"),    # softcap
    (1, 128, 128, 4, 4, 256, True, 0, 0.0, "bfloat16"),    # bf16, gemma D
    (1, 128, 256, 2, 2, 64, False, 0, 0.0, "float32"),     # non-causal, Sk>Sq
]
DECODE_CASES = [
    # (B, S, H, KV, D, pos, window, softcap, dtype)
    (1, 128, 4, 4, 64, 0, 0, 0.0, "float32"),
    (2, 512, 8, 2, 64, 100, 0, 0.0, "float32"),
    (1, 512, 8, 1, 128, 511, 64, 0.0, "float32"),
    (2, 256, 16, 8, 256, 200, 0, 50.0, "float32"),
    (1, 512, 8, 8, 128, 300, 0, 0.0, "bfloat16"),
]
# Many key blocks of the Pallas kernels (64 for flash, 128 for decode),
# scores spread by q, k of standard deviation 1.5.
SPREAD_ATTN_CASES = [
    (1, 512, 512, 4, 2, 64, True, 0, 50.0, "float32"),
    (1, 512, 512, 4, 2, 64, True, 192, 0.0, "float32"),
    (1, 512, 512, 4, 2, 128, True, 0, 50.0, "bfloat16"),
]
SPREAD_DECODE_CASES = [
    (2, 1024, 8, 4, 128, 1023, 0, 50.0, "float32"),
    (1, 1024, 8, 4, 128, 700, 300, 50.0, "float32"),
    (2, 1024, 16, 8, 256, 900, 0, 50.0, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _draw(seed, *shapes, dtype, scales=None):
    """NumPy normals × 0.5 (or × ``scales[i]``) in ``dtype`` (bf16 via
    JAX's rounding), as a JAX array and a torch tensor with the same values."""
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(shapes):
        scale = 0.5 if scales is None else scales[i]
        j = jnp.asarray(rng.standard_normal(s) * scale, jnp.float32).astype(dtype)
        out.append((j, tensor_from_numpy(np.asarray(j))))
    return out


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ATTN_CASES + SPREAD_ATTN_CASES, ids=str)
def test_flash_plain_version_matches_pallas_kernel(case):
    B, Sq, Sk, H, KV, D, causal, window, cap, dt = case
    scales = (1.5, 1.5, 1.0) if case in SPREAD_ATTN_CASES else None
    (qj, qt), (kj, kt), (vj, vt) = _draw(
        Sq + 3 * D + H, (B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), dtype=dt, scales=scales)
    out_k = flash_attention_pallas(
        qj.transpose(0, 2, 1, 3), kj.transpose(0, 2, 1, 3), vj.transpose(0, 2, 1, 3),
        causal=causal, window=window, softcap=cap, blk_q=64, blk_k=64, interpret=True,
    ).transpose(0, 2, 1, 3)
    before = fa_ops.flash_attention.launches
    out_p = fa_ops.flash_attention(qt, kt, vt, causal=causal, window=window, softcap=cap)
    assert fa_ops.flash_attention.launches == before     # the host runs the plain version
    assert out_p.dtype == qt.dtype and out_p.shape == (B, Sq, H, D)
    _close(out_p, out_k, TOL[dt])


@pytest.mark.parametrize("window,cap", [(0, 0.0), (64, 50.0)])
def test_flash_plain_version_matches_models_chunked_path(window, cap):
    B, S, H, KV, D = 1, 256, 4, 2, 64
    (qj, qt), (kj, kt), (vj, vt) = _draw(7, (B, S, H, D), (B, S, KV, D), (B, S, KV, D),
                                         dtype="float32")
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    out_c = _chunked(qj, kj, vj, pos, pos, causal=True, is_global=window == 0,
                     window=window, cap=cap, scale=D ** -0.5, q_block=64, kv_block=64)
    out_p = flash_attention_ref(qt, kt, vt, causal=True, window=window, softcap=cap)
    _close(out_p, out_c, 2e-5)


# MLA's prefill widths (src/repro/models/mla.py:63): queries and keys of
# nope 128 + rope 64 = 192 against values of 128, scale 192^-0.5. The
# Pallas kernel takes one D, so the reference to hold is the model's own
# full-score path, _sdpa (src/repro/models/attention.py:72).
MLA_CASES = [
    # (B, Sq, Sk, H, KV, causal, dtype)
    (1, 77, 77, 4, 4, True, "float32"),
    (2, 130, 130, 4, 2, True, "float32"),
    (1, 64, 200, 2, 2, False, "float32"),
    (1, 200, 200, 4, 4, True, "bfloat16"),
]


@pytest.mark.parametrize("case", MLA_CASES, ids=str)
def test_flash_plain_version_at_mla_widths_matches_sdpa(case):
    B, Sq, Sk, H, KV, causal, dt = case
    (qj, qt), (kj, kt), (vj, vt) = _draw(Sq + Sk, (B, Sq, H, 192), (B, Sk, KV, 192), (B, Sk, KV, 128),
                                         dtype=dt, scales=(1.5, 1.5, 1.0))
    qp = jnp.broadcast_to(jnp.arange(Sq)[None], (B, Sq))
    kp = jnp.broadcast_to(jnp.arange(Sk)[None], (B, Sk))
    ref = _sdpa(qj, kj, vj, qp, kp, causal=causal, is_global=True, window=0, cap=0.0, scale=192 ** -0.5)
    out = fa_ops.flash_attention(qt, kt, vt, causal=causal)
    assert out.dtype == qt.dtype and out.shape == (B, Sq, H, 128)
    _close(out, ref, TOL[dt])


@pytest.mark.parametrize("case", DECODE_CASES + SPREAD_DECODE_CASES, ids=str)
def test_decode_plain_version_matches_pallas_kernel(case):
    B, S, H, KV, D, pos, window, cap, dt = case
    scales = (1.5, 1.5, 1.0) if case in SPREAD_DECODE_CASES else None
    (qj, qt), (kj, kt), (vj, vt) = _draw(S + pos + D, (B, H, D), (B, S, KV, D), (B, S, KV, D),
                                         dtype=dt, scales=scales)
    rep = H // KV
    out_k = decode_attention_pallas(
        qj.reshape(B, KV, rep, D), kj.transpose(0, 2, 1, 3), vj.transpose(0, 2, 1, 3),
        pos, window=window, softcap=cap, blk_s=128, interpret=True,
    ).reshape(B, H, D)
    before = da_ops.decode_attention.launches
    out_p = da_ops.decode_attention(qt, kt, vt, pos, window=window, softcap=cap)
    assert da_ops.decode_attention.launches == before
    _close(out_p, out_k, TOL[dt])


@pytest.mark.parametrize("W", [1, 2, 5, 64])
def test_ring_slot_validity_is_a_prefix(W):
    """Slot j of a ring of W holds position pos − ((pos − j) mod W); it is
    valid (≥ 0) iff j ≤ min(pos, W − 1), which lets the decode kernel
    read a ring as a linear cache."""
    j = np.arange(W)
    for pos in range(300):
        assert np.array_equal(pos - np.mod(pos - j, W) >= 0, j <= min(pos, W - 1))


@pytest.fixture(scope="module")
def ring_setup():
    ref_cfg = ref_get_config("gemma2-9b", reduced=True).replace(
        num_kv_heads=2, param_dtype="float32", compute_dtype="float32", num_layers=2)
    cfg = get_config("gemma2-9b", reduced=True).replace(
        num_kv_heads=2, param_dtype="float32", compute_dtype="float32", num_layers=2)
    tree = jax.tree.map(np.asarray, RefLM(ref_cfg).init(jax.random.PRNGKey(3)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, tree))
    ref_attn = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"]["attn"])
    return ref_cfg, cfg, ref_attn, lm.blocks[0].attn


def test_ring_decode_matches_reference_across_the_wrap(ring_setup):
    """The port's ring decode (``decode_attention(..., ring=True)``: one
    decode-attention call over the ring, read up to min(pos, W − 1))
    against the reference ``_ring_decode``,
    stepping pos from below the ring's size W = 16 to past twice it."""
    ref_cfg, cfg, ref_attn, attn = ring_setup
    W, B = 16, 2
    rng = np.random.default_rng(11)
    ring = rng.standard_normal((2, B, W, cfg.num_kv_heads, cfg.head_dim_)).astype(np.float32)
    rk, rv = jnp.asarray(ring[0]), jnp.asarray(ring[1])
    pk, pv = torch.from_numpy(ring[0].copy()), torch.from_numpy(ring[1].copy())
    step = jax.jit(lambda x, k, v, pos: ref_ring_decode(ref_attn, x, k, v, pos, ref_cfg, 10_000.0))
    for pos in range(10, 40):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        ref_out, rk, rv = step(jnp.asarray(x), rk, rv, jnp.int32(pos))
        out, pk, pv = decode_attention(attn, torch.from_numpy(x), pk, pv, pos, cfg,
                                       is_global=False, ring=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pk.numpy(), np.asarray(rk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-5, atol=1e-5)


class TestWrapperChecks:
    """What the wrappers refuse, on any device (checked before dispatch)."""

    def test_flash_row_without_a_key(self):
        q = torch.zeros((1, 40, 2, 32))
        k = torch.zeros((1, 8, 2, 32))
        with pytest.raises(ValueError, match="sees no key"):
            fa_ops.flash_attention(q, k, k, causal=True, window=4)
        fa_ops.flash_attention(q, k, k, causal=True)   # no window: every row sees key 0

    def test_flash_mixed_types_and_devices(self):
        q = torch.zeros((1, 8, 2, 32))
        with pytest.raises(TypeError, match="share one type"):
            fa_ops.flash_attention(q, q.double(), q)
        with pytest.raises(ValueError, match="several devices"):
            fa_ops.flash_attention(q.to("meta"), q, q)
        # meta takes the shape-only route (test_torch_shapes_serve.py): no launch
        m = q.to("meta")
        out = fa_ops.flash_attention(m, m, m)
        assert out.device.type == "meta" and out.shape == q.shape

    def test_flash_k_and_v_share_all_but_their_width(self):
        q = torch.zeros((1, 8, 2, 192))
        with pytest.raises(ValueError, match="v \\(B,Sk,KV,Dv\\)"):
            fa_ops.flash_attention(q, torch.zeros((1, 8, 2, 192)), torch.zeros((1, 9, 2, 128)))
        with pytest.raises(ValueError, match="v \\(B,Sk,KV,Dv\\)"):
            fa_ops.flash_attention(q, torch.zeros((1, 8, 2, 192)), torch.zeros((1, 8, 1, 128)))

    def test_flash_gqa_shape(self):
        q = torch.zeros((1, 8, 3, 32))
        k = torch.zeros((1, 8, 2, 32))
        with pytest.raises(ValueError, match="multiple of KV"):
            fa_ops.flash_attention(q, k, k)

    @pytest.mark.parametrize("pos", [-1, 16])
    def test_decode_pos_outside_the_cache(self, pos):
        """A negative position raises; a position past the cache's end sees
        every key, as the last position does (key j is visible iff
        key0 + j ≤ pos, the key-range entry's rule)."""
        rng = np.random.default_rng(3)
        q = torch.from_numpy(rng.standard_normal((1, 4, 32)).astype(np.float32))
        k = torch.from_numpy(rng.standard_normal((1, 16, 2, 32)).astype(np.float32))
        if pos < 0:
            with pytest.raises(ValueError, match=f"pos {pos} and key0 0 must be"):
                da_ops.decode_attention(q, k, k, pos)
        else:
            assert torch.equal(da_ops.decode_attention(q, k, k, pos), da_ops.decode_attention(q, k, k, 15))

    def test_decode_plain_version_on_a_strided_layer_view(self):
        rng = np.random.default_rng(2)
        cache = torch.from_numpy(rng.standard_normal((3, 1, 24, 2, 32)).astype(np.float32))
        q = torch.from_numpy(rng.standard_normal((1, 4, 32)).astype(np.float32))
        out = da_ops.decode_attention(q, cache[1], cache[2], 20, window=8)
        ref = decode_attention_ref(q, cache[1].contiguous(), cache[2].contiguous(), 20, window=8)
        assert torch.equal(out, ref)
