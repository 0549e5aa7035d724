"""The port's dense model against the reference, on the CPU.

Reduced gemma2 (4 layers L G L G, d 128, head_dim 32, window 64), once
in float32 with GQA forced on (``num_kv_heads=2``: the reduced config
has KV = H = 4) and once in bfloat16 as published. The reference's
``LM.init`` weights are carried across by ``params_from_reference``;
token ids and caches are drawn with NumPy. Tolerances: float32 1e-4,
bfloat16 2e-2 (the attention kernel tests' bf16 tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config, list_archs as ref_list_archs
from repro.models import LM as RefLM, decode as ref_decode
from repro.models import layers as ref_layers
from repro.models.attention import attention as ref_attention, decode_attention as ref_decode_attention
from repro.models.common import layer_flags as ref_layer_flags
from repro_torch.configs import get_config, list_archs
from repro_torch.models import LM, decode, layer_flags, layers, params_from_reference
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.interop import tensor_from_numpy


def warm_cpu_math():
    """Call each of torch's vectorized CPU math kernels that the port's
    plain versions use once, over enough elements to reach every intra-op
    thread. The first call of such a kernel in a process has been seen to
    come out up to 5e-5 off in relative terms (tanh, exp; about one process
    in a hundred, torch 2.13 on an AVX-512 Xeon), while later calls are
    exact to an ulp; the comparisons here are tighter than that."""
    w = torch.linspace(-4.0, 4.0, 1 << 21)
    for f in (torch.tanh, torch.exp, torch.rsqrt, torch.sin, torch.cos, torch.sigmoid,
              torch.erf, torch.nn.functional.silu, lambda t: torch.softmax(t, 0),
              lambda t: torch.nn.functional.gelu(t, approximate="tanh"),
              lambda t: torch.pow(10_000.0, t)):
        f(w)


warm_cpu_math()

VARIANTS = {
    "f32-gqa": dict(num_kv_heads=2, param_dtype="float32", compute_dtype="float32"),
    "bf16": dict(),
}
TOL = {"f32-gqa": 1e-4, "bf16": 2e-2}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model(request):
    name = request.param
    ref_cfg = ref_get_config("gemma2-9b", reduced=True).replace(remat=False, **VARIANTS[name])
    cfg = get_config("gemma2-9b", reduced=True).replace(remat=False, **VARIANTS[name])
    ref_lm = RefLM(ref_cfg)
    params = ref_lm.init(jax.random.PRNGKey(0))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return dict(name=name, tol=TOL[name], ref_cfg=ref_cfg, cfg=cfg, ref_lm=ref_lm,
                params=params, lm=lm)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _cache_like(ref_cache, seed):
    """Random contents for every cache array (the same for both sides):
    masking by position, not zeros, decides what stale slots contribute."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, a in ref_cache.items():
        j = jnp.asarray(rng.standard_normal(a.shape) * 0.5, jnp.float32).astype(a.dtype)
        out[k] = j
    return out


# -- configs and layers ---------------------------------------------------------


@pytest.mark.parametrize("arch", ref_list_archs())
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal_the_reference(arch, reduced):
    assert list_archs() == ref_list_archs()
    a = dataclasses.asdict(get_config(arch, reduced=reduced))
    b = dataclasses.asdict(ref_get_config(arch, reduced=reduced))
    assert a == b
    cfg = get_config(arch, reduced=reduced)
    ref_flags = ref_layer_flags(ref_get_config(arch, reduced=reduced))
    for key, val in layer_flags(cfg).items():
        assert np.array_equal(val, ref_flags[key])


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-12b", "nemotron-4-15b", "mistral-large-123b"])
def test_full_width_parameter_shapes_equal_the_reference(arch):
    """The published dense configurations, built on the meta device: every
    parameter has the reference's shape (layer i of its stacked tree)."""
    lm = LM(get_config(arch), device="meta")
    shapes = {k: tuple(v.shape) for k, v in lm.state_dict().items()}
    tree = RefLM(ref_get_config(arch)).abstract_params()
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = {}
    for path, leaf in flat:
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            for i in range(leaf.shape[0]):
                want[".".join(["blocks", str(i), *keys[1:]])] = tuple(leaf.shape[1:])
        else:
            want[".".join(keys)] = tuple(leaf.shape)
    assert shapes == want
    if arch == "gemma2-9b":
        assert sum(int(np.prod(s)) for s in shapes.values()) == 9_241_404_928


def test_layers_match_the_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    xt, st = torch.from_numpy(x), torch.from_numpy(scale)
    _close(layers.rms_norm(xt, st), ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), 1e-6)
    _close(layers.softcap(xt * 40, 30.0), ref_layers.softcap(jnp.asarray(x) * 40, 30.0), 1e-5)
    pos = np.arange(5)[None].repeat(2, 0) + 90
    _close(layers.rope(xt, torch.from_numpy(pos), 10_000.0),
           ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), 1e-5)
    w = {n: rng.standard_normal(s).astype(np.float32) * 0.1
         for n, s in (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    for kind in ("swiglu", "geglu", "squared_relu", "gelu"):
        _close(layers.mlp({k: torch.from_numpy(v) for k, v in w.items()}, xt, kind),
               ref_layers.mlp({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), kind),
               1e-5)


def test_interop_carries_bfloat16_bits_exactly():
    a = jnp.asarray(np.random.default_rng(0).standard_normal((7, 3)), jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(a))
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(), np.asarray(a).view(np.int16))


# -- layer outputs -----------------------------------------------------------------


@pytest.mark.parametrize("is_global", [True, False])
def test_attention_layer(model, is_global):
    """Prefill attention over 96 positions (past the window of 64)."""
    cfg, ref_cfg = model["cfg"], model["ref_cfg"]
    B, S = 2, 96
    rng = np.random.default_rng(2)
    xj = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)), jnp.float32).astype(ref_cfg.cdtype)
    positions = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    p_ref = jax.tree.map(lambda a: a[1], model["params"]["blocks"]["attn"])
    ref = ref_attention(p_ref, xj, ref_cfg, positions, is_global=is_global)
    out = attention(model["lm"].blocks[1].attn, tensor_from_numpy(np.asarray(xj)), cfg,
                    is_global=is_global)
    assert out.dtype == cfg.cdtype
    _close(out, ref, model["tol"])


@pytest.mark.parametrize("is_global,pos", [(True, 80), (False, 80), (False, 20)])
def test_decode_attention_layer(model, is_global, pos):
    cfg, ref_cfg = model["cfg"], model["ref_cfg"]
    B, S = 2, 96
    rng = np.random.default_rng(pos)
    xj = jnp.asarray(rng.standard_normal((B, 1, cfg.d_model)), jnp.float32).astype(ref_cfg.cdtype)
    shape = (B, S, cfg.num_kv_heads, cfg.head_dim_)
    kj, vj = (jnp.asarray(rng.standard_normal(shape) * 0.5, jnp.float32).astype(ref_cfg.cdtype)
              for _ in range(2))
    p_ref = jax.tree.map(lambda a: a[0], model["params"]["blocks"]["attn"])
    ref, rk, rv = ref_decode_attention(p_ref, xj, kj, vj, jnp.int32(pos), ref_cfg,
                                       is_global=is_global)
    kt, vt = tensor_from_numpy(np.asarray(kj)), tensor_from_numpy(np.asarray(vj))
    out, kt2, vt2 = decode_attention(model["lm"].blocks[0].attn, tensor_from_numpy(np.asarray(xj)),
                                     kt, vt, pos, cfg, is_global=is_global)
    assert kt2 is kt and vt2 is vt                    # written in place
    _close(out, ref, model["tol"])
    _close(kt, rk, model["tol"])
    _close(vt, rv, model["tol"])


# -- the model ----------------------------------------------------------------------


def test_forward_logits(model):
    cfg = model["cfg"]
    toks = _tokens(cfg, 2, 80)
    ref, _ = model["ref_lm"].forward(model["params"], jnp.asarray(toks))
    out, aux = model["lm"].forward(torch.from_numpy(toks))
    assert out.dtype == torch.float32 and out.shape == (2, 80, cfg.padded_vocab)
    assert float(aux) == 0.0
    _close(out, ref, model["tol"])
    last, _ = model["lm"].forward(torch.from_numpy(toks), last_only=True)
    torch.testing.assert_close(last, out[:, -1:], rtol=1e-6, atol=1e-6)   # one row vs S rows


def test_decode_steps_and_caches_across_the_ring_wrap(model):
    """16 decode steps from pos 56 with max_len 96: the local layers'
    rings of 64 wrap at pos 64. Both sides start from the same random
    cache contents."""
    cfg, tol = model["cfg"], model["tol"]
    ref_lm, params, lm = model["ref_lm"], model["params"], model["lm"]
    B, max_len = 2, 96
    ref_cache = _cache_like(ref_decode.init_cache(ref_lm, B, max_len), seed=4)
    cache = decode.init_cache(lm, B, max_len)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {k: v.shape for k, v in ref_cache.items()}
    for k in cache:
        cache[k].copy_(tensor_from_numpy(np.asarray(ref_cache[k])))
    step = jax.jit(lambda p, t, c, pos: ref_decode.decode_step(ref_lm, p, t, c, pos))
    toks = _tokens(cfg, B, 16, seed=5)
    for n, pos in enumerate(range(56, 72)):
        ref, ref_cache = step(params, jnp.asarray(toks[:, n : n + 1]), ref_cache, jnp.int32(pos))
        out, cache = decode.decode_step(lm, torch.from_numpy(toks[:, n : n + 1]), cache, pos)
        _close(out, ref, tol)
    for k in cache:
        ref_k = _np(ref_cache[k])
        # bf16 caches hold activations of magnitude ~3: compare at the
        # tolerance relative to the cache's scale
        _close(cache[k], ref_k, tol * max(1.0, float(np.abs(ref_k).max())))


def test_prefill_equals_decode_inside_the_port():
    """LM.forward logits ≡ a decode_step loop over the same tokens
    (tests/models/test_smoke_archs.py's check, 2e-3), float32."""
    cfg = get_config("gemma2-9b", reduced=True).replace(
        num_kv_heads=2, param_dtype="float32", compute_dtype="float32")
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=6))
    full, _ = lm.forward(toks)
    cache = decode.init_cache(lm, 2, 24)
    outs = []
    for t in range(16):
        lt, cache = decode.decode_step(lm, toks[:, t : t + 1], cache, t)
        outs.append(lt[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=2e-3, atol=2e-3)


def test_init_is_seeded_and_default_device_is_the_card(monkeypatch):
    cfg = get_config("gemma2-9b", reduced=True).replace(num_layers=2)
    a = LM(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = LM(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert a.embed.dtype == torch.bfloat16 and a.final_norm.dtype == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-12b", "nemotron-4-15b", "mistral-large-123b"])
def test_dense_configurations_forward_and_decode(arch):
    """Every dense configuration, reduced, in float32, weights carried
    across: LM.forward over 80 tokens and 72 decode steps from position 0
    (past the local layers' rings of 64 where the pattern has them) within
    1e-4 of the reference. The paths only some of them take: QK-norm and a
    second rope theta on global layers (gemma3), squared ReLU (nemotron),
    rope_theta 1e6 and an untied head (mistral)."""
    kw = dict(remat=False, param_dtype="float32", compute_dtype="float32")
    ref_cfg = ref_get_config(arch, reduced=True).replace(**kw)
    cfg = get_config(arch, reduced=True).replace(**kw)
    ref_lm = RefLM(ref_cfg)
    params = ref_lm.init(jax.random.PRNGKey(1))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    toks = _tokens(cfg, 2, 80, seed=7)
    ref, _ = ref_lm.forward(params, jnp.asarray(toks))
    out, _ = lm.forward(torch.from_numpy(toks))
    _close(out, ref, 1e-4)
    ref_cache = ref_decode.init_cache(ref_lm, 2, 80)
    cache = decode.init_cache(lm, 2, 80)
    step = jax.jit(lambda p, t, c, pos: ref_decode.decode_step(ref_lm, p, t, c, pos))
    for pos in range(72):
        r, ref_cache = step(params, jnp.asarray(toks[:, pos : pos + 1]), ref_cache, jnp.int32(pos))
        o, cache = decode.decode_step(lm, torch.from_numpy(toks[:, pos : pos + 1]), cache, pos)
        _close(o, r, 1e-4)
