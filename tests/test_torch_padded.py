"""The attention kernels' padded route for head widths without an
instance, and the forward's row log-sum-exp, on the CPU.

On the card a (D, Dv) outside ``flash_attention.ops.PAIRS`` (and a
decode D outside ``HEAD_DIMS``) runs the smallest instance that covers
it on q, k and v with zero columns appended, at the true width's scale
D^-0.5, and slices the outputs back. The card alone runs the kernels
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here the same route
runs through the plain versions and is held to the unpadded plain
version, forward and backward, at the widths the card now pads: MLA's
reduced (48, 32), the 100m preset's head_dim 80 and (192, 64). Then
the route in place of the models' attention, held to the reference on
the reduced deepseek-v2 and on a dense model at the 100m preset's
attention widths (``examples/train_smalllm.py``): prefill, decode and
gradients against ``jax.grad``, at the tolerances of the port's model
tests (float32 1e-4, gradients 1e-4 of each leaf's max |g|). Last, the
plain forward's log-sum-exp against ``scipy.special.logsumexp`` of the
same masked, capped scores in NumPy (float32 1e-6 relative), and the
plain backward from that lse against its softmax route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp

from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM, ModelConfig as RefModelConfig, decode as ref_decode
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_attention_bwd_ref, flash_attention_ref
from repro_torch.models import LM, ModelConfig, attention as attention_mod, decode, params_from_reference


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers share the host's
    cores (tests/test_torch_cpu_math.py times its forks)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


PADDED = [(48, 32), (80, 80), (192, 64)]
# (B, Sq, Sk, H, KV, causal, window, cap)
CASES = [
    (1, 40, 40, 4, 2, True, 0, 0.0),
    (2, 33, 33, 6, 3, True, 9, 50.0),
    (1, 12, 50, 4, 1, False, 0, 30.0),
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-6, "bfloat16": 2e-2}      # of the largest |unpadded|


def _draw(rng, shape, dtype, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dtype)


def _zero_cols(t, width):
    return torch.cat([t, t.new_zeros(t.shape[:-1] + (width - t.shape[-1],))], dim=-1)


def _within(got, want, tol, what):
    err, big = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
    assert err <= tol * big, f"{what}: max |diff| {err} > {tol} · {big}"


def test_instance_choice_and_what_no_route_covers():
    assert [fa_ops.instance(*p) for p in PADDED] == [(64, 64), (128, 128), (192, 128)]
    assert all(fa_ops.instance(*p) == p for p in fa_ops.PAIRS)
    assert fa_ops.instance(130, 64) == (192, 128) and fa_ops.instance(200, 130) == (256, 256)
    assert fa_ops.instance(320, 64) is None and fa_ops.instance(64, 320) is None
    assert [da_ops.instance(d) for d in (48, 80, 32, 256, 200)] == [64, 128, 32, 256, 256]
    assert da_ops.instance(320) is None


def test_pad_qkv_builds_one_kv_buffer():
    rng = np.random.default_rng(0)
    q, k, v = _draw(rng, (1, 5, 4, 48), torch.float32), _draw(rng, (1, 7, 2, 48), torch.float32), \
        _draw(rng, (1, 7, 2, 32), torch.float32)
    qp, kp, vp = fa_ops.pad_qkv(q, k, v, (64, 64))
    assert qp.shape == (1, 5, 4, 64) and kp.shape == vp.shape == (1, 7, 2, 64)
    assert kp.stride() == vp.stride() and vp.data_ptr() == kp.data_ptr() + 64 * kp.element_size()
    assert torch.equal(qp[..., :48], q) and torch.equal(kp[..., :48], k) and torch.equal(vp[..., :32], v)
    assert not qp[..., 48:].any() and not kp[..., 48:].any() and not vp[..., 32:].any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("pair", PADDED, ids=str)
def test_padded_forward_through_the_plain_version_equals_unpadded(pair, case, dtype):
    D, Dv = pair
    B, Sq, Sk, H, KV, causal, window, cap = case
    dt = DTYPES[dtype]
    rng = np.random.default_rng(D + Dv + Sq)
    q, k, v = _draw(rng, (B, Sq, H, D), dt, 1.5), _draw(rng, (B, Sk, KV, D), dt, 1.5), _draw(rng, (B, Sk, KV, Dv), dt)
    opts = dict(causal=causal, window=window, softcap=cap)
    want, want_lse = flash_attention_ref(q, k, v, return_lse=True, **opts)
    qp, kp, vp = fa_ops.pad_qkv(q, k, v, fa_ops.instance(D, Dv))
    got, lse = flash_attention_ref(qp, kp, vp, scale=D ** -0.5, return_lse=True, **opts)
    assert not got[..., Dv:].float().any()
    _within(got[..., :Dv], want, TOL[dtype], "o")
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("pair", PADDED, ids=str)
def test_padded_backward_through_the_plain_version_equals_unpadded(pair, case, dtype):
    D, Dv = pair
    B, Sq, Sk, H, KV, causal, window, cap = case
    dt = DTYPES[dtype]
    rng = np.random.default_rng(3 * D + Dv + Sk)
    q, k, v = _draw(rng, (B, Sq, H, D), dt, 1.5), _draw(rng, (B, Sk, KV, D), dt, 1.5), _draw(rng, (B, Sk, KV, Dv), dt)
    do = _draw(rng, (B, Sq, H, Dv), dt)
    opts = dict(causal=causal, window=window, softcap=cap)
    o = flash_attention_ref(q, k, v, **opts)
    want = flash_attention_bwd_ref(q, k, v, o, do, **opts)
    DQK, DV = fa_ops.instance(D, Dv)
    qp, kp, vp = fa_ops.pad_qkv(q, k, v, (DQK, DV))
    dq, dk, dv = flash_attention_bwd_ref(qp, kp, vp, _zero_cols(o, DV), _zero_cols(do, DV), scale=D ** -0.5, **opts)
    for name, g, w, width in (("dq", dq, want[0], D), ("dk", dk, want[1], D), ("dv", dv, want[2], Dv)):
        assert not g[..., width:].float().any(), name
        _within(g[..., :width], w, TOL[dtype] if dtype == "bfloat16" else 1e-5, name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [48, 80])
def test_padded_decode_through_the_plain_version_equals_unpadded(D, dtype):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(D)
    q, k, v = _draw(rng, (3, 8, D), dt, 1.5), _draw(rng, (3, 40, 2, D), dt, 1.5), _draw(rng, (3, 40, 2, D), dt)
    Dk = da_ops.instance(D)
    for pos, window, cap in ((39, 0, 50.0), (20, 7, 0.0)):
        want = decode_attention_ref(q, k, v, pos, window=window, softcap=cap)
        got = decode_attention_ref(_zero_cols(q, Dk), _zero_cols(k, Dk), _zero_cols(v, Dk), pos, window=window,
                                   softcap=cap, scale=D ** -0.5)
        assert not got[..., D:].float().any()
        _within(got[..., :D], want, TOL[dtype], f"pos {pos}")


def test_the_host_wrappers_take_any_width_without_padding():
    """On the host the wrappers run the plain versions at the inputs'
    widths (uncounted); the padded route is the card's."""
    rng = np.random.default_rng(1)
    q, k, v = _draw(rng, (1, 9, 4, 48), torch.float32), _draw(rng, (1, 9, 2, 48), torch.float32), \
        _draw(rng, (1, 9, 2, 32), torch.float32)
    before = (fa_ops.flash_attention.launches, fa_ops.flash_attention.padded, da_ops.decode_attention.padded)
    assert torch.equal(fa_ops.flash_attention(q, k, v, softcap=50.0), flash_attention_ref(q, k, v, softcap=50.0))
    o, lse = fa_ops.flash_attention(q, k, v, window=4, return_lse=True)
    want, want_lse = flash_attention_ref(q, k, v, window=4, return_lse=True)
    assert torch.equal(o, want) and torch.equal(lse, want_lse)
    qd, kd = q[:, 0, :, :], k[..., :48]
    assert torch.equal(da_ops.decode_attention(qd, kd, kd, 5), decode_attention_ref(qd, kd, kd, 5))
    assert (fa_ops.flash_attention.launches, fa_ops.flash_attention.padded, da_ops.decode_attention.padded) == before


# -- the forward's row log-sum-exp -------------------------------------------------

LSE_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, cap)
    (1, 77, 77, 4, 2, 32, True, 0, 0.0),
    (2, 40, 40, 6, 2, 64, True, 9, 50.0),
    (1, 12, 50, 4, 1, 128, False, 0, 30.0),
    (1, 64, 64, 2, 2, 32, True, 1, 50.0),
]


def _np_scores(q, k, causal, window, cap):
    """(B, H, Sq, Sk) masked, capped float32 scores in NumPy."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kk = np.repeat(k, H // KV, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kk) * np.float32(D ** -0.5)
    if cap > 0:
        s = np.float32(cap) * np.tanh(s / np.float32(cap))
    qp, kp = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= (qp - kp) < window
    return np.where(ok, s, np.float32(NEG_INF)).astype(np.float32)


@pytest.mark.parametrize("case", LSE_CASES, ids=str)
def test_plain_forward_lse_equals_scipy_logsumexp(case):
    B, Sq, Sk, H, KV, D, causal, window, cap = case
    rng = np.random.default_rng(Sq + D)
    q = (rng.standard_normal((B, Sq, H, D)) * 1.5).astype(np.float32)
    k = (rng.standard_normal((B, Sk, KV, D)) * 1.5).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
    _, lse = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window, softcap=cap,
                                 return_lse=True)
    want = logsumexp(_np_scores(q, k, causal, window, cap).astype(np.float64), axis=-1)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", LSE_CASES, ids=str)
def test_plain_backward_from_the_lse_equals_its_softmax_route(case):
    B, Sq, Sk, H, KV, D, causal, window, cap = case
    rng = np.random.default_rng(Sk + 2 * D)
    q, k, v = (_draw(rng, s, torch.float32, 1.5) for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))
    do = _draw(rng, (B, Sq, H, D), torch.float32)
    opts = dict(causal=causal, window=window, softcap=cap)
    o, lse = flash_attention_ref(q, k, v, return_lse=True, **opts)
    want = flash_attention_bwd_ref(q, k, v, o, do, **opts)
    got = flash_attention_bwd_ref(q, k, v, o, do, lse=lse, **opts)
    floor = 0.1 * max(float(w.abs().max()) for w in want)    # window 1: dq, dk are rounding
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-5 * max(float(w.abs().max()), floor), f"{name}: {err}"


# -- the route in place of the models' attention, against the reference --------------

def _padded_flash(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The card's padded route through the plain version, differentiable."""
    D, Dv = q.shape[-1], v.shape[-1]
    pair = fa_ops.instance(D, Dv)
    assert pair != (D, Dv), "a width the card runs unpadded"
    qp, kp, vp = fa_ops.pad_qkv(q, k, v, pair)
    return flash_attention_ref(qp, kp, vp, causal=causal, window=window, softcap=softcap,
                               scale=D ** -0.5)[..., :Dv]


def _padded_decode(q, k, v, pos, *, window=0, softcap=0.0):
    D = q.shape[-1]
    Dk = da_ops.instance(D)
    assert Dk != D
    out = decode_attention_ref(_zero_cols(q, Dk), _zero_cols(k, Dk), _zero_cols(v, Dk), pos, window=window,
                               softcap=softcap, scale=D ** -0.5)
    return out[..., :D]


@pytest.fixture
def padded_route(monkeypatch):
    """Every attention call of the port's models through the padded route."""
    calls = {"flash": 0, "decode": 0}

    def flash(*a, **kw):
        calls["flash"] += 1
        return _padded_flash(*a, **kw)

    def dec(*a, **kw):
        calls["decode"] += 1
        return _padded_decode(*a, **kw)

    monkeypatch.setattr(attention_mod, "flash_attention", flash)
    monkeypatch.setattr(attention_mod, "decode_attention_kernel", dec)
    return calls


SMALL_100M = dict(name="small-100m", num_layers=2, d_model=640, num_heads=8, num_kv_heads=4, head_dim=80,
                  d_ff=2560, vocab_size=512, mlp="swiglu", tie_embeddings=True, param_dtype="float32",
                  compute_dtype="float32", remat=False, max_seq_len=64)


def _models(arch):
    if arch == "small-100m":
        ref_cfg, cfg = RefModelConfig(**SMALL_100M), ModelConfig(**SMALL_100M)
    else:
        kw = dict(remat=False, param_dtype="float32", compute_dtype="float32")
        ref_cfg, cfg = ref_get_config(arch, reduced=True).replace(**kw), get_config(arch, reduced=True).replace(**kw)
    ref_lm = RefLM(ref_cfg)
    params = ref_lm.init(jax.random.PRNGKey(2))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return ref_lm, params, lm


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a.detach().float().numpy()), np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["small-100m", "deepseek-v2-236b"])
def test_models_through_the_padded_route_equal_the_reference(arch, padded_route):
    """Prefill logits over 20 tokens and 12 decode steps (the dense model's
    decode attention padded too; MLA's absorbed decode runs no kernel)."""
    ref_lm, params, lm = _models(arch)
    toks = np.random.default_rng(5).integers(0, lm.cfg.vocab_size, (2, 20)).astype(np.int32)
    ref, _ = ref_lm.forward(params, jnp.asarray(toks))
    out, _ = lm.forward(torch.from_numpy(toks))
    _close(out, ref, 1e-4)
    assert padded_route["flash"] == lm.cfg.num_layers
    ref_cache, cache = ref_decode.init_cache(ref_lm, 2, 16), decode.init_cache(lm, 2, 16)
    step = jax.jit(lambda p, t, c, pos: ref_decode.decode_step(ref_lm, p, t, c, pos))
    for pos in range(12):
        r, ref_cache = step(params, jnp.asarray(toks[:, pos:pos + 1]), ref_cache, jnp.int32(pos))
        o, cache = decode.decode_step(lm, torch.from_numpy(toks[:, pos:pos + 1]), cache, pos)
        _close(o, r, 1e-4)
    assert padded_route["decode"] == (12 * lm.cfg.num_layers if arch == "small-100m" else 0)


@pytest.mark.parametrize("arch", ["small-100m", "deepseek-v2-236b"])
def test_gradients_through_the_padded_route_equal_jax_grad(arch, padded_route):
    ref_lm, params, lm = _models(arch)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, lm.cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, lm.cfg.vocab_size, (2, 16)).astype(np.int32)
    labels[:, -2:] = -1
    rgrads = jax.grad(lambda p: ref_lm.loss(p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})[0])(params)
    lm.requires_grad_(True)
    total, _ = lm.loss({"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    total.backward()
    assert padded_route["flash"] == lm.cfg.num_layers
    want = params_from_reference(lm.cfg, jax.tree.map(np.asarray, rgrads))
    got = dict(lm.named_parameters())
    assert want.keys() == got.keys()
    for name, g in want.items():
        big = float(np.abs(g.numpy()).max())
        err = float((got[name].grad - g).abs().max())
        assert err <= 1e-4 * max(big, 1e-12), f"{name}: {err} > 1e-4 · {big}"
