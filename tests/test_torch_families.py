"""The port's hybrid, ssm, vlm and encdec families against the reference,
on the CPU.

Each family at the reference's reduced configuration with the settings
of its own prefill ≡ decode oracle (tests/models/test_smoke_archs.py:
``local_window=8``, ``ssm_chunk=8``), and one cut: the reduced vlm has
4 layers, less than one period of ``cross_attn_every`` = 5, so the
reference builds it with no layer at all; here it keeps 10 (two periods
of four self layers and a cross layer). The reference's cross layers
start with a tanh gate of 0, which would hide them; the gates are set to
0.3 … 0.9 in the reference's tree before it is carried across by
``params_from_reference``. Token ids and embeddings are drawn with
NumPy.

The port is held to the reference's float32 computation of the same
weights and inputs: within 1e-4 when the port runs in float32, within
2e-2 (the dense model tests' bf16 tolerance) when it runs in bfloat16
(weights and inputs rounded to bfloat16 first, on both sides). The
reference's own bfloat16 run is no closer to that computation than the
port's (about 0.017 and 0.019 of 1 + |logit| for the reduced hybrid,
0.019 and 0.017 for mamba2 at 64 tokens), so the two bfloat16 runs
differ from each other by the sum of two roundings, which 2e-2 does not
hold everywhere; their difference is not what the tolerance bounds.
Prefill ≡ decode: 2e-3 in float32 (the reference oracle's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as ref_attention_mod
from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM, decode as ref_decode
from repro.models.attention import _chunked as ref_chunked, attention as ref_attention
from repro.models.decode import _cross_attend as ref_cross_attend
from repro.models.rglru import rglru_forward as ref_rglru_forward
from repro.models.ssm import _segsum as ref_segsum, mamba_forward as ref_mamba_forward
from repro.serving import InferenceRequest as RefRequest, ServingEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import LM, decode, params_from_reference
from repro_torch.models import attention as attention_mod, interop
from repro_torch.models.attention import _chunked, attention, cross_decode
from repro_torch.models.interop import tensor_from_numpy
from repro_torch.models.rglru import linear_scan, rglru_forward
from repro_torch.models.ssm import _segsum, mamba_forward
from repro_torch.serving import InferenceRequest, ServingEngine
from test_torch_models import warm_cpu_math

warm_cpu_math()

ARCHS = ["recurrentgemma-2b", "mamba2-780m", "llama-3.2-vision-11b", "whisper-base"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The full-width parameter counts of the reference's LM.init trees
# (chip_smoke.py's weight-streaming bounds read the same numbers).
FULL_PARAMS = {"recurrentgemma-2b": 2_894_481_920, "mamba2-780m": 780_382_464,
               "llama-3.2-vision-11b": 9_775_157_256, "whisper-base": 83_250_182,
               "deepseek-v2-236b": 235_741_434_880, "deepseek-v3-671b": 671_026_419_200}


def _cfg_kw(arch, dtype):
    kw = dict(remat=False, param_dtype=dtype, compute_dtype=dtype, local_window=8, ssm_chunk=8)
    if arch == "llama-3.2-vision-11b":
        kw["num_layers"] = 10
    return kw


def _with_gates(params):
    params = dict(params)
    for key in ("cross_blocks", "dec_cross"):
        if key in params:
            n = params[key]["xgate"].shape[0]
            params[key] = dict(params[key], xgate=jnp.asarray(np.linspace(0.3, 0.9, n), jnp.float32))
    return params


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in DTYPES], ids=lambda p: f"{p[0]}-{p[1]}")
def family(request):
    arch, dtype = request.param
    ref_cfg = ref_get_config(arch, reduced=True).replace(**_cfg_kw(arch, dtype))
    cfg = get_config(arch, reduced=True).replace(**_cfg_kw(arch, dtype))
    params = _with_gates(RefLM(ref_cfg).init(jax.random.PRNGKey(0)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    # the reference's float32 computation of the same (rounded) weights
    ref_cfg = ref_cfg.replace(param_dtype="float32", compute_dtype="float32")
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return dict(arch=arch, dtype=dtype, tol=TOL[dtype], ref_cfg=ref_cfg, cfg=cfg,
                ref_lm=RefLM(ref_cfg), params=params, lm=lm)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                      np.asarray(x).astype(np.float32), np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _draw(rng, shape, dtype, scale=0.1):
    """NumPy normals × scale rounded to ``dtype``: the JAX array (in
    float32 for the reference's float32 computation) and a torch tensor
    in ``dtype`` with the same values."""
    j = jnp.asarray(rng.standard_normal(shape) * scale, jnp.float32).astype(dtype)
    return j.astype(jnp.float32), tensor_from_numpy(np.asarray(j))


def _inputs(fam, B, S, seed=0):
    """Tokens and the family's embeddings: (ref kwargs, port kwargs, tokens)."""
    cfg = fam["cfg"]
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    ref_kw, kw = {}, {}
    if cfg.family == "vlm":
        ref_kw["image_embeds"], kw["image_embeds"] = _draw(
            rng, (B, cfg.num_image_tokens, cfg.d_model), fam["dtype"])
    if cfg.family == "encdec":
        ref_kw["audio_embeds"], kw["audio_embeds"] = _draw(
            rng, (B, cfg.encoder_seq_len, cfg.d_model), fam["dtype"])
    return ref_kw, kw, toks


# -- the model ----------------------------------------------------------------------


def test_forward_logits(family):
    """64 tokens: with the window of 8 the hybrid's local layers take the
    banded chunked route on both sides (8 · 8 ≤ 64)."""
    ref_kw, kw, toks = _inputs(family, 2, 64)
    ref, _ = family["ref_lm"].forward(family["params"], jnp.asarray(toks), **ref_kw)
    out, aux = family["lm"].forward(torch.from_numpy(toks), **kw)
    assert out.dtype == torch.float32 and out.shape == (2, 64, family["cfg"].padded_vocab)
    assert float(aux) == 0.0
    _close(out, ref, family["tol"])
    last, _ = family["lm"].forward(torch.from_numpy(toks), last_only=True, **kw)
    torch.testing.assert_close(last, out[:, -1:], rtol=1e-6, atol=1e-6)


def test_decode_steps_and_caches(family):
    """16 decode steps from position 0 over a max_len of 24 (the
    hybrid's rings of 8 wrap twice): the logits of every step and, at
    the end, every cache against the reference's."""
    cfg, tol = family["cfg"], family["tol"]
    ref_lm, params, lm = family["ref_lm"], family["params"], family["lm"]
    B, T = 2, 16
    ref_kw, kw, toks = _inputs(family, B, T, seed=1)
    ref_cache = ref_decode.init_cache(ref_lm, B, T + 8, params=params, **ref_kw)
    cache = decode.init_cache(lm, B, T + 8, **kw)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {k: v.shape for k, v in ref_cache.items()}
    want = {k: "float32" if k in ("h", "extra_h", "state") else family["dtype"] for k in ref_cache}
    assert {k: str(v.dtype).split(".")[1] for k, v in cache.items()} == want
    step = jax.jit(lambda p, t, c, pos: ref_decode.decode_step(ref_lm, p, t, c, pos))
    for t in range(T):
        ref, ref_cache = step(params, jnp.asarray(toks[:, t : t + 1]), ref_cache, jnp.int32(t))
        out, cache = decode.decode_step(lm, torch.from_numpy(toks[:, t : t + 1]), cache, t)
        _close(out, ref, tol)
    for k in cache:
        ref_k = _np(ref_cache[k])
        # bf16 caches hold activations of a few units: the tolerance is
        # relative to the cache's scale
        _close(cache[k], ref_k, tol * max(1.0, float(np.abs(ref_k).max())))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_decode_inside_the_port(arch):
    """LM.forward logits ≡ a decode_step loop over the same 16 tokens,
    float32, 2e-3 (the reference's oracle), from a seeded init."""
    cfg = get_config(arch, reduced=True).replace(**_cfg_kw(arch, "float32"))
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for blocks in (getattr(lm, "cross_blocks", ()), getattr(lm, "dec_cross", ())):
        for b in blocks:
            b.xgate.fill_(0.5)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    kw = {}
    if cfg.family == "vlm":
        kw["image_embeds"] = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32) * 0.1)
    if cfg.family == "encdec":
        kw["audio_embeds"] = torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32) * 0.1)
    full, _ = lm.forward(toks, **kw)
    cache = decode.init_cache(lm, 2, 24, **kw)
    outs = []
    for t in range(16):
        lt, cache = decode.decode_step(lm, toks[:, t : t + 1], cache, t)
        outs.append(lt[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=2e-3, atol=2e-3)


# -- the blocks ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [1, 7, 200])
def test_rglru_forward(dtype, S):
    """The doubling scan against the reference's associative scan (in
    float32, as every test here), over lengths that are not powers of two."""
    ref_cfg = ref_get_config("recurrentgemma-2b", reduced=True).replace(
        param_dtype=dtype, compute_dtype=dtype)
    cfg = get_config("recurrentgemma-2b", reduced=True).replace(param_dtype=dtype, compute_dtype=dtype)
    tree = jax.tree.map(np.asarray, RefLM(ref_cfg).init(jax.random.PRNGKey(4)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, tree))
    p_ref = jax.tree.map(lambda a: jnp.asarray(a[0, 1], jnp.float32), tree["rec_blocks"]["mix"])
    xj, xt = _draw(np.random.default_rng(S), (2, S, cfg.d_model), dtype, scale=1.0)
    _close(rglru_forward(lm.rec_blocks[0][1].mix, xt, cfg),
           ref_rglru_forward(p_ref, xj, ref_cfg.replace(param_dtype="float32", compute_dtype="float32")),
           TOL[dtype])


def test_linear_scan_equals_the_sequential_recurrence():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (3, 37, 5)))
    b = torch.from_numpy(rng.standard_normal((3, 37, 5)))
    h, want = torch.zeros(3, 5, dtype=torch.float64), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(linear_scan(a, b), torch.stack(want, 1), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 8), (32, 32)])
def test_mamba_forward(dtype, S, chunk):
    """Chunked SSD over several chunks (one, four, six) against the
    reference's."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype, ssm_chunk=chunk)
    ref_cfg = ref_get_config("mamba2-780m", reduced=True).replace(**kw)
    cfg = get_config("mamba2-780m", reduced=True).replace(**kw)
    tree = jax.tree.map(np.asarray, RefLM(ref_cfg).init(jax.random.PRNGKey(5)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, tree))
    p_ref = jax.tree.map(lambda a: jnp.asarray(a[2], jnp.float32), tree["blocks"]["mix"])
    xj, xt = _draw(np.random.default_rng(S + chunk), (2, S, cfg.d_model), dtype, scale=1.0)
    _close(mamba_forward(lm.blocks[2].mix, xt, cfg),
           ref_mamba_forward(p_ref, xj, ref_cfg.replace(param_dtype="float32", compute_dtype="float32")),
           TOL[dtype])


def test_mamba_forward_keeps_the_chunk_assertion():
    cfg = get_config("mamba2-780m", reduced=True).replace(ssm_chunk=8)
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mamba_forward(lm.blocks[0].mix, torch.zeros((1, 12, cfg.d_model), dtype=cfg.cdtype), cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segsum(dtype):
    x = np.random.default_rng(6).standard_normal((2, 3, 8)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    got = _segsum(tensor_from_numpy(np.asarray(xj)))
    want = np.asarray(ref_segsum(xj).astype(jnp.float32))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(np.isneginf(got.float().numpy()), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.float().numpy()[fin], want[fin], rtol=TOL[dtype], atol=TOL[dtype])


# -- attention: cross, non-causal and the chunked host route ---------------------------


@pytest.fixture(scope="module")
def attn_setup():
    """A reduced llama-vision model in float32, GQA 4/2, with a logit
    soft-cap of 30 (zero in the published config) so that its presence in
    cross prefill and absence in cross decode both show."""
    kw = dict(param_dtype="float32", compute_dtype="float32", num_layers=5, num_kv_heads=2,
              attn_logit_softcap=30.0)
    ref_cfg = ref_get_config("llama-3.2-vision-11b", reduced=True).replace(**kw)
    cfg = get_config("llama-3.2-vision-11b", reduced=True).replace(**kw)
    tree = jax.tree.map(np.asarray, RefLM(ref_cfg).init(jax.random.PRNGKey(6)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, tree))
    p_ref = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["cross_blocks"]["attn"])
    return ref_cfg, cfg, p_ref, lm.cross_blocks[0].attn


@pytest.mark.parametrize("Sq,Sk", [(24, 16), (16, 24), (9, 1)])
def test_cross_attention_prefill_and_decode(attn_setup, Sq, Sk):
    ref_cfg, cfg, p_ref, p = attn_setup
    rng = np.random.default_rng(Sq * 31 + Sk)
    xj, xt = _draw(rng, (2, Sq, cfg.d_model), jnp.float32, scale=1.5)
    kj, kt = _draw(rng, (2, Sk, cfg.d_model), jnp.float32, scale=1.5)
    pos = jnp.broadcast_to(jnp.arange(Sq)[None], (2, Sq))
    _close(attention(p, xt, cfg, causal=False, kv_x=kt),
           ref_attention(p_ref, xj, ref_cfg, pos, causal=False, kv_x=kj), 1e-4)
    ck = jnp.einsum("bnd,dhk->bnhk", kj, p_ref["wk"])
    cv = jnp.einsum("bnd,dhk->bnhk", kj, p_ref["wv"])
    _close(cross_decode(p, xt[:, :1], tensor_from_numpy(np.asarray(ck)),
                        tensor_from_numpy(np.asarray(cv)), cfg),
           ref_cross_attend(p_ref, xj[:, :1], ck, cv, ref_cfg), 1e-4)


def test_noncausal_self_attention_takes_rotary(attn_setup):
    """whisper's encoder: non-causal self-attention with rotary embeddings."""
    ref_cfg, cfg, p_ref, p = attn_setup
    xj, xt = _draw(np.random.default_rng(8), (2, 40, cfg.d_model), jnp.float32, scale=1.5)
    pos = jnp.broadcast_to(jnp.arange(40)[None], (2, 40))
    _close(attention(p, xt, cfg, causal=False), ref_attention(p_ref, xj, ref_cfg, pos, causal=False), 1e-4)


@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, H, KV, D, causal, window, cap, q_block, kv_block, banded, dtype)
    (1, 64, 64, 4, 2, 32, True, 0, 0.0, 16, 16, False, "float32"),
    (2, 96, 96, 4, 1, 32, True, 12, 50.0, 16, 24, True, "float32"),
    (1, 128, 128, 2, 2, 64, True, 16, 0.0, 32, 16, True, "bfloat16"),
    (1, 48, 40, 4, 2, 32, False, 0, 30.0, 16, 16, False, "float32"),
    (1, 30, 21, 4, 4, 32, False, 0, 0.0, 8, 8, False, "bfloat16"),
], ids=str)
def test_chunked_path_equals_the_references(case):
    B, Sq, Sk, H, KV, D, causal, window, cap, qb, kb, banded, dt = case
    rng = np.random.default_rng(Sq + Sk + window)
    (qj, qt), (kj, kt), (vj, vt) = (_draw(rng, s, dt, scale=c) for s, c in
                                    (((B, Sq, H, D), 1.5), ((B, Sk, KV, D), 1.5), ((B, Sk, KV, D), 1.0)))
    qp = jnp.broadcast_to(jnp.arange(Sq)[None], (B, Sq))
    kp = jnp.broadcast_to(jnp.arange(Sk)[None], (B, Sk))
    ref = ref_chunked(qj, kj, vj, qp, kp, causal=causal, is_global=window == 0, window=window,
                      cap=cap, scale=D ** -0.5, q_block=qb, kv_block=kb, banded=banded)
    out = _chunked(qt, kt, vt, causal=causal, window=window, cap=cap, scale=D ** -0.5,
                   q_block=qb, kv_block=kb, banded=banded)
    assert out.dtype == qt.dtype
    _close(out, ref, 2e-5 if dt == "float32" else 2e-2)


def test_host_route_takes_chunked_where_the_reference_does(monkeypatch):
    """Banded for a local layer with window · 8 ≤ Sk, chunked above the
    threshold (lowered to 32 on both sides), the full-score plain version
    otherwise; each against the reference's attention."""
    kw = dict(param_dtype="float32", compute_dtype="float32", local_window=8, num_kv_heads=2)
    ref_cfg = ref_get_config("gemma2-9b", reduced=True).replace(**kw)
    cfg = get_config("gemma2-9b", reduced=True).replace(**kw)
    tree = jax.tree.map(np.asarray, RefLM(ref_cfg).init(jax.random.PRNGKey(7)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, tree))
    p_ref = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"]["attn"])
    calls = []
    real = attention_mod._chunked
    monkeypatch.setattr(attention_mod, "_chunked", lambda *a, **k: calls.append(k["banded"]) or real(*a, **k))
    for threshold in (8192, 32):
        monkeypatch.setattr(attention_mod, "CHUNKED_THRESHOLD", threshold)
        monkeypatch.setattr(ref_attention_mod, "CHUNKED_THRESHOLD", threshold)
        for S, is_global in ((48, False), (64, False), (64, True)):
            xj, xt = _draw(np.random.default_rng(S), (1, S, cfg.d_model), jnp.float32, scale=1.0)
            pos = jnp.broadcast_to(jnp.arange(S)[None], (1, S))
            _close(attention(lm.blocks[0].attn, xt, cfg, is_global=is_global),
                   ref_attention(p_ref, xj, ref_cfg, pos, is_global=is_global), 1e-4)
    # threshold 8192: only the local layer at 64 = 8 · 8 keys chunks (banded);
    # threshold 32: every call chunks, banded where the window allows
    assert calls == [True, False, True, False]


# -- serving, configurations, errors -------------------------------------------------


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-780m"])
def test_engine_equals_the_reference_engine(arch):
    """launch/serve.py's traffic shape on the reduced model in float32:
    identical tokens, first-token and finish times and stats."""
    kw = dict(remat=False, param_dtype="float32", compute_dtype="float32")
    ref_cfg = ref_get_config(arch, reduced=True).replace(**kw)
    cfg = get_config(arch, reduced=True).replace(**kw)
    ref_lm = RefLM(ref_cfg)
    params = ref_lm.init(jax.random.PRNGKey(0))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
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


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-780m"])
def test_cli_serves_the_recurrent_families_on_the_host(arch, capsys):
    stats, reqs = serve.main(["--arch", arch, "--device", "cpu", "--requests", "4", "--new-tokens", "3"])
    assert stats.served == 4 and all(len(r.generated) == 3 for r in reqs)
    assert "served=4/4" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-base"])
def test_engine_raises_without_embeddings_as_the_reference_does(arch):
    cfg = get_config(arch, reduced=True)
    with pytest.raises(AssertionError):
        ref_lm = RefLM(ref_get_config(arch, reduced=True))
        RefEngine(ref_lm, ref_lm.init(jax.random.PRNGKey(0)), num_slots=2, max_len=16)
    with pytest.raises(ValueError, match="embeds"):
        ServingEngine(LM(cfg, device="cpu"), num_slots=2, max_len=16)


@pytest.mark.parametrize("arch", ARCHS + ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_full_width_parameter_shapes_equal_the_reference(arch, monkeypatch):
    """The published configurations, built on the meta device: every
    parameter has the reference's shape and type (one module a layer,
    named after its place in the reference's stacked tree). For the two
    deepseek configurations the reference's leaves cross as meta tensors:
    copying them would take 1.3 TB for deepseek-v3 alone."""
    cfg = get_config(arch)
    lm = LM(cfg, device="meta")
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in lm.state_dict().items()}
    tree = RefLM(ref_get_config(arch)).abstract_params()
    if cfg.family == "moe":
        monkeypatch.setattr(interop, "tensor_from_numpy", lambda a: torch.empty(
            a.shape, dtype=torch.bfloat16 if a.dtype.name == "bfloat16" else getattr(torch, a.dtype.name),
            device="meta"))
    want = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in params_from_reference(cfg, jax.tree.map(
                lambda s: np.lib.stride_tricks.as_strided(np.zeros((), s.dtype), s.shape,
                                                          (0,) * len(s.shape)), tree)).items()}
    assert got == want
    assert sum(int(np.prod(s)) for s, _ in got.values()) == FULL_PARAMS[arch]
