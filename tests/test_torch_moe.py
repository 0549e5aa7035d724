"""The port's moe family (MLA attention, routed experts) against the
reference, on the CPU.

deepseek-v2-236b (softmax router, two shared experts reduced to one) and
deepseek-v3-671b (sigmoid router with ``router_bias``) at the reference's
reduced configurations (``get_config(arch, reduced=True)``: 4 layers, the
first dense, 8 experts top-2, MLA ranks 64/32 and head widths 32/16/32),
with the full-rank query branch (``q_lora_rank=0``) beside the low-rank
one. The reference initialises ``router_bias`` to zeros, which would
leave the biased selection untested; it is drawn from NumPy here before
the tree is carried across by ``params_from_reference``. Inputs are drawn
with NumPy.

Tolerances as tests/test_torch_families.py: the port within 1e-4 of the
reference's float32 computation in float32, within 2e-2 in bfloat16.
In bfloat16 a whole model is not compared: rounding the router's input a
little differently can flip a near-tie expert choice, which changes a
token's output by a whole expert and is no fault. Each bf16 block is
held instead against the reference's bf16 block given the reference's
input to it (the router then sees the same bf16 values on both sides),
and one MoE layer against the reference's float32 computation of the
same rounded input. Prefill ≡ decode: 2e-3 in float32, dropless
(``capacity_factor`` 64, as the reference's own oracle).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as ref_attention_mod
import repro.models.moe as ref_moe
from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM, decode as ref_decode
from repro.models.lm import _mla_block as ref_mla_block
from repro.models.mla import init_mla_cache as ref_init_mla_cache
from repro.models.mla import mla_attention as ref_mla_attention, mla_decode as ref_mla_decode
from repro.serving import InferenceRequest as RefRequest, ServingEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import LM, decode, params_from_reference
from repro_torch.models import attention as attention_mod
from repro_torch.models import moe
from repro_torch.models.interop import tensor_from_numpy
from repro_torch.models.mla import init_mla_cache, mla_attention, mla_decode
from repro_torch.serving import InferenceRequest, ServingEngine
from test_torch_models import warm_cpu_math

warm_cpu_math()

ARCHS = ["deepseek-v2-236b", "deepseek-v3-671b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                      np.asarray(x).astype(np.float32), np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _cfgs(arch, dtype="float32", **kw):
    kw = dict(remat=False, param_dtype=dtype, compute_dtype=dtype, **kw)
    return ref_get_config(arch, reduced=True).replace(**kw), get_config(arch, reduced=True).replace(**kw)


def _models(arch, dtype="float32", seed=0, **kw):
    """(ref_cfg, cfg, ref_lm, reference params, port LM) with the same weights;
    router_bias drawn from NumPy where the router is sigmoid."""
    ref_cfg, cfg = _cfgs(arch, dtype, **kw)
    ref_lm = RefLM(ref_cfg)
    params = ref_lm.init(jax.random.PRNGKey(seed))
    if cfg.router == "sigmoid":
        mb = params["moe_blocks"]
        bias = np.random.default_rng(seed + 100).standard_normal(mb["moe"]["router_bias"].shape) * 0.05
        params = dict(params, moe_blocks=dict(mb, moe=dict(mb["moe"], router_bias=jnp.asarray(bias, jnp.float32))))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    return ref_cfg, cfg, ref_lm, params, lm


def _draw(rng, shape, dtype, scale=1.0):
    """NumPy normals × scale rounded to ``dtype``: the JAX array (float32)
    and a torch tensor in ``dtype`` with the same values."""
    j = jnp.asarray(rng.standard_normal(shape) * scale, jnp.float32).astype(dtype)
    return j.astype(jnp.float32), _t(j)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# -- routing -------------------------------------------------------------------------


@pytest.mark.parametrize("T,K,E,skew", [(64, 2, 8, 0.0), (37, 6, 16, 0.0), (200, 8, 32, 2.0), (5, 3, 4, 1.0)])
def test_positions_in_expert_keep_and_slots_equal_the_reference(T, K, E, skew):
    """Each token's K distinct experts drawn with a skew toward the low
    ones; positions, keep and slots equal the reference's exactly, at a
    capacity where tokens are dropped."""
    rng = np.random.default_rng(T * K + E)
    w = np.exp(-skew * np.arange(E) / E)
    idx = np.stack([rng.choice(E, K, replace=False, p=w / w.sum()) for _ in range(T)]).astype(np.int32)
    got = moe._positions_in_expert(torch.from_numpy(idx).long(), E)
    want = np.asarray(ref_moe._positions_in_expert(jnp.asarray(idx), E))
    np.testing.assert_array_equal(got.numpy(), want)
    C = max(1, T * K // (2 * E))                   # half the mean load: some experts overflow
    keep, ref_keep = got < C, want < C
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    assert not bool(keep.all())
    slot = torch.where(keep, torch.from_numpy(idx).long() * C + got, E * C)
    np.testing.assert_array_equal(slot.numpy(), np.where(ref_keep, idx * C + want, E * C))
    # every kept slot is unique: the scatter needs no accumulation
    assert len(set(slot[keep].tolist())) == int(keep.sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_route_equals_the_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(3)
    E, d = cfg.num_experts, cfg.d_model
    x = rng.standard_normal((96, d)).astype(np.float32)
    p = {"router": (rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32)}
    if cfg.router == "sigmoid":
        p["router_bias"] = (rng.standard_normal(E) * 0.05).astype(np.float32)
    gates, idx, probs = moe._route({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), cfg)
    rg, ri, rp = ref_moe._route({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), ref_cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gates.numpy(), np.asarray(rg), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(rp), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_ties_take_the_lower_expert_as_lax_top_k_does(arch):
    """A zero router makes every score equal: both pick experts 0…K−1.
    Rows of repeated small integers hold _top_k to lax.top_k on ties."""
    ref_cfg, cfg = _cfgs(arch)
    E, K, d = cfg.num_experts, cfg.top_k, cfg.d_model
    p = {"router": np.zeros((d, E), np.float32)}
    if cfg.router == "sigmoid":
        p["router_bias"] = np.zeros(E, np.float32)
    x = np.random.default_rng(4).standard_normal((6, d)).astype(np.float32)
    _, idx, _ = moe._route({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), cfg)
    _, ri, _ = ref_moe._route({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), ref_cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    assert idx.tolist() == [list(range(K))] * 6
    s = np.random.default_rng(5).integers(0, 3, (50, E)).astype(np.float32)
    vals, ti = moe._top_k(torch.from_numpy(s), K)
    rv, rti = jax.lax.top_k(jnp.asarray(s), K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(rti))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 0.3])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_equals_the_reference(arch, cf, dtype):
    """y and aux of one MoE layer (routed and shared experts), at the
    configured capacity and at one low enough that tokens drop, against
    the reference's float32 computation of the same rounded input."""
    _, _, _, params, lm = _models(arch, dtype, capacity_factor=cf)
    ref_cfg, cfg = _cfgs(arch, "float32", capacity_factor=cf)
    p_ref = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), _layer(params["moe_blocks"], 1)["moe"])
    xj, xt = _draw(np.random.default_rng(6), (2, 24, cfg.d_model), dtype)
    y, aux = moe.moe_layer(lm.moe_blocks[1].moe, xt, lm.cfg)
    ry, raux = ref_moe.moe_layer(p_ref, xj, ref_cfg)
    assert y.dtype == xt.dtype and aux.dtype == torch.float32
    _close(y, ry, TOL[dtype])
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    if cf < 1:       # the reference drops here too
        _, idx, _ = moe._route(lm.moe_blocks[1].moe, xt.reshape(-1, cfg.d_model), lm.cfg)
        C = max(8, int(48 * cfg.top_k * cf / cfg.num_experts))
        assert not bool((moe._positions_in_expert(idx, cfg.num_experts) < C).all())


# -- MLA -------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [64, 0])
def test_mla_attention_equals_the_reference(q_lora, dtype):
    _, _, _, params, lm = _models("deepseek-v2-236b", dtype, q_lora_rank=q_lora)
    ref_cfg, cfg = _cfgs("deepseek-v2-236b", "float32", q_lora_rank=q_lora)
    p_ref = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), _layer(params["moe_blocks"], 0)["attn"])
    xj, xt = _draw(np.random.default_rng(7), (2, 40, cfg.d_model), dtype)
    pos = jnp.broadcast_to(jnp.arange(40)[None], (2, 40))
    out = mla_attention(lm.moe_blocks[0].attn, xt, lm.cfg)
    assert out.dtype == xt.dtype
    _close(out, ref_mla_attention(p_ref, xj, ref_cfg, pos), TOL[dtype])


def test_mla_attention_takes_the_chunked_route_where_the_reference_does(monkeypatch):
    """The threshold lowered to 32 on both sides: 24 tokens take the full
    scores, 600 the chunked path (two query blocks of 300); each held to
    the reference, whose route switches at the same length."""
    ref_cfg, cfg, _, params, lm = _models("deepseek-v2-236b")
    p_ref = _layer(params["moe_blocks"], 0)["attn"]
    calls = []
    real = attention_mod._chunked
    monkeypatch.setattr(attention_mod, "_chunked", lambda *a, **k: calls.append(k["scale"]) or real(*a, **k))
    monkeypatch.setattr(attention_mod, "CHUNKED_THRESHOLD", 32)
    monkeypatch.setattr(ref_attention_mod, "CHUNKED_THRESHOLD", 32)
    for S in (24, 600):
        xj, xt = _draw(np.random.default_rng(S), (1, S, cfg.d_model), jnp.float32)
        pos = jnp.broadcast_to(jnp.arange(S)[None], (1, S))
        _close(mla_attention(lm.moe_blocks[0].attn, xt, cfg), ref_mla_attention(p_ref, xj, ref_cfg, pos), 1e-4)
    assert calls == [(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5]


@pytest.mark.parametrize("q_lora", [64, 0])
def test_mla_decode_and_latent_caches_equal_the_reference(q_lora):
    """12 absorbed-form steps from position 0 over a 16-row cache: each
    step's output, and both latent caches after each step."""
    ref_cfg, cfg, _, params, lm = _models("deepseek-v2-236b", q_lora_rank=q_lora)
    p_ref = _layer(params["moe_blocks"], 1)["attn"]
    p = lm.moe_blocks[1].attn
    B, S = 2, 16
    ref_c = {k: v[0] for k, v in ref_init_mla_cache(ref_cfg, B, S, 1).items()}
    c = {k: v[0] for k, v in init_mla_cache(cfg, B, S, 1).items()}
    step = jax.jit(lambda x, ck, kr, pos: ref_mla_decode(p_ref, x, ck, kr, pos, ref_cfg))
    rng = np.random.default_rng(8)
    for t in range(12):
        xj, xt = _draw(rng, (B, 1, cfg.d_model), jnp.float32)
        ref_out, ref_c["c_kv"], ref_c["k_rope"] = step(xj, ref_c["c_kv"], ref_c["k_rope"], jnp.int32(t))
        out, ck, kr = mla_decode(p, xt, c["c_kv"], c["k_rope"], t, cfg)
        assert ck is c["c_kv"] and kr is c["k_rope"]          # written in place
        _close(out, ref_out, 1e-4)
        for k in c:
            _close(c[k], ref_c[k], 1e-5)


# -- the model -------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def f32_model(request):
    return _models(request.param)


def test_forward_logits_and_aux(f32_model):
    ref_cfg, cfg, ref_lm, params, lm = f32_model
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    ref, ref_aux = ref_lm.forward(params, jnp.asarray(toks))
    out, aux = lm.forward(torch.from_numpy(toks))
    assert out.dtype == torch.float32 and out.shape == (2, 32, cfg.padded_vocab)
    _close(out, ref, 1e-4)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    last, last_aux = lm.forward(torch.from_numpy(toks), last_only=True)
    torch.testing.assert_close(last, out[:, -1:], rtol=1e-6, atol=1e-6)
    assert float(last_aux) == float(aux)


def test_decode_steps_and_caches(f32_model):
    """12 decode steps from position 0 over a max_len of 16: each step's
    logits and, at the end, both caches of both layer groups."""
    ref_cfg, cfg, ref_lm, params, lm = f32_model
    B, T = 2, 12
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    ref_cache = ref_decode.init_cache(ref_lm, B, T + 4, params=params)
    cache = decode.init_cache(lm, B, T + 4)
    shapes = lambda c: {g: {k: tuple(v.shape) for k, v in d.items()} for g, d in c.items()}  # noqa: E731
    assert shapes(cache) == shapes(ref_cache) and set(cache) == {"dense", "moe"}
    step = jax.jit(lambda p, t, c, pos: ref_decode.decode_step(ref_lm, p, t, c, pos))
    for t in range(T):
        ref, ref_cache = step(params, jnp.asarray(toks[:, t : t + 1]), ref_cache, jnp.int32(t))
        out, cache = decode.decode_step(lm, torch.from_numpy(toks[:, t : t + 1]), cache, t)
        _close(out, ref, 1e-4)
    for g in cache:
        for k in cache[g]:
            _close(cache[g][k], ref_cache[g][k], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_blocks_equal_the_reference_blocks(arch):
    """bfloat16: every block (the dense one and the three MoE ones) of the
    port against the reference's bf16 block, each given the reference's
    own input to it, 24 tokens; the blocks' aux losses too."""
    ref_cfg, cfg, ref_lm, params, lm = _models(arch, "bfloat16")
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    x = ref_lm._embed(params, jnp.asarray(toks))
    pos = jnp.broadcast_to(jnp.arange(24)[None], (2, 24))
    blocks = [(_layer(params[g], i), b) for g in ("dense_blocks", "moe_blocks")
              for i, b in enumerate(getattr(lm, g))]
    for p_ref, blk in blocks:
        ref_y, ref_aux = ref_mla_block(p_ref, x, ref_cfg, pos)
        y, aux = blk(_t(x), cfg)
        assert y.dtype == torch.bfloat16
        _close(y, ref_y, 2e-2)
        if aux is None:
            assert ref_aux == 0.0
        else:
            np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
        x = ref_y


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_decode_inside_the_port(arch):
    """LM.forward logits ≡ a decode_step loop over the same 16 tokens,
    float32, 2e-3, dropless (capacity_factor 64): a 32-token prefill
    would otherwise drop tokens that a 2-token decode step keeps."""
    cfg = get_config(arch, reduced=True).replace(param_dtype="float32", compute_dtype="float32",
                                                 capacity_factor=64.0)
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 16)))
    full, _ = lm.forward(toks)
    cache = decode.init_cache(lm, 2, 24)
    outs = []
    for t in range(16):
        lt, cache = decode.decode_step(lm, toks[:, t : t + 1], cache, t)
        outs.append(lt[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=2e-3, atol=2e-3)


# -- serving, interop ---------------------------------------------------------------------


def test_engine_equals_the_reference_engine():
    """launch/serve.py's traffic shape on reduced deepseek-v2 in float32:
    identical tokens, first-token and finish times and stats."""
    ref_cfg, cfg, ref_lm, params, lm = _models("deepseek-v2-236b")
    runs = []
    for engine_cls, req_cls, args in ((RefEngine, RefRequest, (ref_lm, params)),
                                      (ServingEngine, InferenceRequest, (lm,))):
        rng = np.random.default_rng(0)
        eng = engine_cls(*args, num_slots=4, max_len=32, quotas={"tenant-a": 100.0, "tenant-b": 100.0})
        reqs = [req_cls(user=f"tenant-{'ab'[i % 2]}",
                        prompt=rng.integers(0, cfg.vocab_size, 8 if i < 6 else 5).astype(np.int32),
                        max_new_tokens=6) for i in range(8)]
        for i, r in enumerate(reqs):
            eng.submit(r, now=float(i))
        stats = eng.run_until_drained()
        runs.append(([(r.generated, r.first_token_time, r.finish_time) for r in reqs],
                     dataclasses.asdict(stats)))
    assert runs[0] == runs[1]
    assert runs[1][1]["served"] == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_moe_family_on_the_host(arch, capsys):
    stats, reqs = serve.main(["--arch", arch, "--device", "cpu", "--requests", "4", "--new-tokens", "3"])
    assert stats.served == 4 and all(len(r.generated) == 3 for r in reqs)
    assert "served=4/4" in capsys.readouterr().out


@pytest.mark.parametrize("q_lora", [64, 0])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_covers_every_leaf(arch, q_lora):
    """Every reference leaf, split along its stacking axis, names one
    parameter of the port with its shape and type, and every parameter is
    named once."""
    ref_cfg, cfg = _cfgs(arch, q_lora_rank=q_lora)
    tree = jax.tree.map(np.asarray, RefLM(ref_cfg).init(jax.random.PRNGKey(1)))
    sd = params_from_reference(cfg, tree)
    n_leaves = sum(a.shape[0] if path[0].key in ("dense_blocks", "moe_blocks") else 1
                   for path, a in jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(sd) == n_leaves
    want = LM(cfg, device="meta").state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in sd.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in want.items()}
    assert ("moe_blocks.0.moe.router_bias" in sd) == (cfg.router == "sigmoid")
    assert ("moe_blocks.0.attn.wq" in sd) == (q_lora == 0)
