"""The sharded decode paths on ``torch.distributed`` against the
reference's own sharded functions, on the CPU.

The reference runs in a subprocess under eight forced host devices
(``tests/_jax_sharded_reference.py``, a 2 × 4 ("data", "model") mesh as
its ``tests/models/test_sharded_decode.py`` and ``test_moe_impls.py``
build it); the port runs on eight spawned gloo ranks on the same mesh
(``launch.mesh.run_ranks``, a file rendezvous in a fresh temporary
directory, one intra-op thread a rank; ``tests/_torch_sharded_ranks.py``),
the two at once. Both read the same inputs, drawn here with NumPy from
fixed seeds (the decode steps' parameters from the port's seeded
initialiser, carried to both through the reference's tree and
``models.interop.params_from_reference``). Each rank's block of an output
is held against the same block of the reference's sharded output and of
its naive counterpart, at the reference tests' tolerances: decode
outputs 2e-4, caches rtol 1e-5 / atol 1e-6, the ring and MLA 3e-4, the
moe output 2e-4, its aux rtol 1e-3 / atol 1e-5 and its gradients rtol
5e-3 / atol 5e-4; the port's sharded ``decode_step`` (through
``build_serve_step``) against the port's and the reference's unsharded
one at 2e-4, for reduced gemma2 (local rings and global layers) and the
hybrid (recurrentgemma, one kv head: its key and value projections
replicated over 'model') across a ring wrap, and for the vlm
(llama-3.2-vision, self layers between cross layers) and encdec
(whisper, the decoder's self layers over an encoder pass's cross K/V),
their linear caches written on every shard; each rank holds the rules'
blocks (``param_specs(..., serve=True)``, ``cache_specs``), every layer
through its sharded body, and again under ``REPRO_SHARDED_DECODE=0``
(every layer gathering its blocks at use). ``init_cache`` under the mesh
projects each rank's block of the cross K/V (along N, or along D where
17 image tokens do not divide 'model'). The caches start from random
rows (the reference's own tests start from zeros, where only the first
shard sees a key before the wrap), so that every shard's softmax state
counts in the combine. A second mesh, 2 × 2 × 2 with a pod axis, holds
the batch rows' pod-major order and the moe layer's experts replicated
over pods.

The applicability and layout helpers equal the reference's over a grid
of mesh shapes, and ``runtime.sharding.local_block`` tiles every
parameter and cache spec exactly.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attention, moe as ref_moe
from repro.runtime import pspec as ref_pspec
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import LM, attention, decode, moe, params_from_reference
from repro_torch.models.interop import STACKED
from repro_torch.runtime import pspec, sharding
from repro_torch.runtime.serve import abstract_cache

import _torch_sharded_ranks as ranks

REPO = Path(__file__).resolve().parents[1]
MESH = {"data": 2, "model": 4}                 # the reference tests' mesh
POD = {"pod": 2, "data": 2, "model": 2}        # batch rows over (pod, data), pod-major
F32 = dict(param_dtype="float32", compute_dtype="float32")
RING_STEPS = [0, 1, 2, 3, 510, 511, 512, 513, 600]
MOE = dict(arch="deepseek-v2-236b", over=dict(F32, capacity_factor=64.0), S=16)   # dropless
DENSE = dict(arch="gemma2-9b", over=dict(F32, local_window=512))
CASES = {
    "linear": dict(kind="linear", arch="gemma2-9b", over=dict(F32, local_window=0, layer_pattern="G"), B=2,
                   S=1024, steps=[0, 1, 2, 300, 700, 1023]),
    "ring": dict(DENSE, kind="ring", B=2, S=512, steps=RING_STEPS),
    "mla": dict(kind="mla", arch="deepseek-v2-236b", over=F32, B=2, S=1024, steps=[0, 1, 2, 300, 700, 1023]),
    "moe_2d": dict(MOE, kind="moe", B=2),
    "moe_1d": dict(MOE, kind="moe", B=2, over=dict(MOE["over"], num_experts=12)),
    "decode_gemma2": dict(DENSE, kind="decode", B=4, max_len=1024, steps=RING_STEPS),
    "decode_hybrid": dict(kind="decode", arch="recurrentgemma-2b", over=dict(F32, local_window=512), B=4,
                          max_len=1024, steps=RING_STEPS),
    # two periods of three self layers and a cross layer (no stacked axis as long as the batch, which
    # runtime.sharding.cache_specs would take for it); the cross K/V of 16 image tokens
    "decode_vlm": dict(kind="decode", arch="llama-3.2-vision-11b", over=dict(F32, num_layers=8, cross_attn_every=4), B=4,
                       max_len=1024, steps=[0, 1, 300, 600, 1023]),
    # three decoder self layers over the cross K/V of an encoder pass over 64 frames
    "decode_encdec": dict(kind="decode", arch="whisper-base", over=dict(F32, num_layers=3), B=4, max_len=1024,
                          steps=[0, 1, 300, 600, 1023], frames=64),
    # REPRO_SHARDED_DECODE=0, the reference's baseline: every layer gathers its blocks at use
    "decode_hybrid_baseline": dict(kind="decode", arch="recurrentgemma-2b", over=dict(F32, local_window=512), B=4,
                                   max_len=1024, steps=[0, 1, 600], baseline=True),
    "decode_encdec_baseline": dict(kind="decode", arch="whisper-base", over=dict(F32, num_layers=3), B=4,
                                   max_len=1024, steps=[0, 1, 600], frames=64, baseline=True),
    # init_cache under the mesh: each cross layer's block of its K/V, cut along N (64 image tokens, 64 frames
    # through whisper's encoder on the rank's blocks) or along D (17 image tokens do not divide 'model')
    "cross_vlm_n": dict(kind="cross_blocks", arch="llama-3.2-vision-11b",
                        over=dict(F32, num_layers=8, cross_attn_every=4, num_image_tokens=64), B=4, max_len=256),
    "cross_vlm_d": dict(kind="cross_blocks", arch="llama-3.2-vision-11b",
                        over=dict(F32, num_layers=8, cross_attn_every=4, num_image_tokens=17), B=4, max_len=256),
    "cross_encdec": dict(kind="cross_blocks", arch="whisper-base", over=dict(F32, num_layers=3), B=4, max_len=256,
                         frames=64),
    "refusals": dict(kind="refusals", dense=DENSE, moe=MOE),
    # a pod axis: rows over (pod, data); the moe experts over model × data, replicated over pod
    "pod_linear": dict(kind="linear", arch="gemma2-9b", over=dict(F32, local_window=0, layer_pattern="G"), B=4,
                       S=1024, steps=[0, 1, 600, 1023], mesh=POD),
    "pod_mlp": dict(kind="mlp", arch="gemma2-9b", over=dict(F32, mlp="geglu"), B=4, mesh=POD),
    "pod_moe": dict(MOE, kind="moe", B=4, mesh=POD),
    "pod_decode": dict(DENSE, kind="decode", B=4, max_len=1024, steps=[0, 1, 510, 511, 512, 513, 600], mesh=POD),
}
# every MLP kind; f not divisible by 'model' (replicated); a batch of 1 (replicated rows)
for kind in ("geglu", "swiglu", "squared_relu", "gelu"):
    CASES[f"mlp_{kind}"] = dict(kind="mlp", arch="gemma2-9b", over=dict(F32, mlp=kind), B=2)
CASES["mlp_f250"] = dict(kind="mlp", arch="gemma2-9b", over=dict(F32, mlp="swiglu", d_ff=250), B=2)
CASES["mlp_b1"] = dict(kind="mlp", arch="gemma2-9b", over=dict(F32, mlp="geglu"), B=1)
for c in CASES.values():
    c.setdefault("mesh", MESH)


def _of(kind):
    return sorted(k for k, c in CASES.items() if c["kind"] == kind)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as every CPU-heavy port test file (ROADMAP C3)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _w(rng, *shape):
    """N(0, 1)/√fan_in, fan_in the first dimension."""
    return (rng.standard_normal(shape) / math.sqrt(shape[0])).astype(np.float32)


def _lm_tree(cfg, seed: int) -> dict:
    """The reference's parameter tree (flat '/' keys, NumPy leaves) of a
    model the port initialises from ``seed``, its zero-initialised norm
    scales and cross gates drawn N(0, 0.1) so that they count."""
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    groups: dict = {}
    for name, p in lm.named_parameters():
        a = p.detach().numpy().copy()
        if a.ndim <= 1 and not a.any():
            a = np.asarray(rng.standard_normal(a.shape) * 0.1, dtype=np.float32)
        parts = name.split(".")
        n = STACKED.get(parts[0], 0)
        key = "/".join([parts[0], *parts[1 + n:]])
        groups.setdefault(key, {})[tuple(int(i) for i in parts[1:1 + n])] = a
    out = {}
    for key, by_index in groups.items():
        idx = sorted(by_index)
        stack = tuple(max(i[d] for i in idx) + 1 for d in range(len(idx[0])))
        out[key] = np.stack([by_index[i] for i in idx]).reshape(stack + by_index[idx[0]].shape)
    return out


def _inputs(cases) -> dict:
    rng = np.random.default_rng(23)
    inp = {}
    for key in _of("linear") + _of("ring"):
        c = cases[key]
        cfg = get_config(c["arch"], reduced=True).replace(**c["over"])
        d, H, KV, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        inp |= {f"{key}/wq": _w(rng, d, H, D), f"{key}/wk": _w(rng, d, KV, D), f"{key}/wv": _w(rng, d, KV, D),
                f"{key}/wo": _w(rng, H * D, d).reshape(H, D, d)}
        for kv in "kv":       # the cache's rows before the first step: random, so that every shard counts
            inp[f"{key}/{kv}0"] = rng.standard_normal((c["B"], c["S"], KV, D)).astype(np.float32)
        for t in c["steps"]:
            inp[f"{key}/x{t}"] = (rng.standard_normal((c["B"], 1, d)) * 0.3).astype(np.float32)
    for key in _of("mlp"):
        c = cases[key]
        cfg = get_config(c["arch"], reduced=True).replace(**c["over"])
        d, f = cfg.d_model, cfg.d_ff
        inp |= {f"{key}/w_gate": _w(rng, d, f), f"{key}/w_up": _w(rng, d, f), f"{key}/w_down": _w(rng, f, d),
                f"{key}/x": (rng.standard_normal((c["B"], 1, d)) * 0.5).astype(np.float32)}
    c = cases["mla"]
    cfg = get_config(c["arch"], reduced=True).replace(**c["over"])
    d, H, rq, rkv = cfg.d_model, cfg.num_heads, cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    inp |= {"mla/wq_a": _w(rng, d, rq), "mla/q_norm": (rng.standard_normal(rq) * 0.1).astype(np.float32),
            "mla/wq_b": _w(rng, rq, H, dn + dr), "mla/wkv_a": _w(rng, d, rkv + dr),
            "mla/kv_norm": (rng.standard_normal(rkv) * 0.1).astype(np.float32),
            "mla/wkv_b": _w(rng, rkv, H, dn + dv), "mla/wo": _w(rng, H * dv, d).reshape(H, dv, d)}
    inp["mla/c_kv0"] = rng.standard_normal((c["B"], c["S"], rkv)).astype(np.float32)
    inp["mla/k_rope0"] = rng.standard_normal((c["B"], c["S"], dr)).astype(np.float32)
    for t in c["steps"]:
        inp[f"mla/x{t}"] = (rng.standard_normal((c["B"], 1, d)) * 0.3).astype(np.float32)
    for key in _of("moe"):
        c = cases[key]
        cfg = get_config(c["arch"], reduced=True).replace(**c["over"])
        E, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
        fs = f * cfg.num_shared_experts
        inp |= {f"{key}/router": _w(rng, d, E), f"{key}/w_gate": _w(rng, E, d, f) * math.sqrt(E / d),
                f"{key}/w_up": _w(rng, E, d, f) * math.sqrt(E / d),
                f"{key}/w_down": _w(rng, E, f, d) * math.sqrt(E / f),
                f"{key}/shared/w_gate": _w(rng, d, fs), f"{key}/shared/w_up": _w(rng, d, fs),
                f"{key}/shared/w_down": _w(rng, fs, d),
                f"{key}/x": (rng.standard_normal((c["B"], c["S"], d)) * 0.3).astype(np.float32)}
    for key in _of("cross_blocks"):
        c = cases[key]
        cfg = get_config(c["arch"], reduced=True).replace(**c["over"])
        inp |= {f"{key}/params/{k}": v for k, v in _lm_tree(cfg, seed=6).items()}
        name, n = ("image_embeds", cfg.num_image_tokens) if cfg.family == "vlm" else ("audio_embeds", c["frames"])
        inp[f"{key}/{name}"] = rng.standard_normal((c["B"], n, cfg.d_model)).astype(np.float32)
    for key in _of("decode"):
        c = cases[key]
        cfg = get_config(c["arch"], reduced=True).replace(**c["over"])
        inp |= {f"{key}/params/{k}": v for k, v in _lm_tree(cfg, seed=5).items()}
        cache = decode.init_cache(LM(cfg, device="meta"), c["B"], c["max_len"],
                                  **ranks.cross_inputs(cfg, c, c["B"], "meta"))
        for k, v in cache.items():
            inp[f"{key}/cache/{k}"] = (rng.standard_normal(tuple(v.shape)) * 0.5).astype(np.float32)
        inp[f"{key}/tokens"] = rng.integers(0, cfg.vocab_size, (c["B"], len(c["steps"]))).astype(np.int32)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, each rank's results, the inputs): the
    reference subprocess and the eight ranks run at the same time."""
    work = tmp_path_factory.mktemp("sharded")
    (work / "cases.json").write_text(json.dumps(CASES))
    inp = _inputs(CASES)
    np.savez(work / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref_proc = subprocess.Popen([sys.executable, str(REPO / "tests" / "_jax_sharded_reference.py"), str(work)],
                                env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = {name: run_ranks(ranks.run, mesh, backend="gloo", device_type="cpu", args=(str(work),), timeout=300)
                for name, mesh in (("2x4", MESH), ("pod", POD))}
    finally:
        out, err = ref_proc.communicate(timeout=600)
    assert ref_proc.returncode == 0 and "OK" in out, out + "\n" + err
    return dict(np.load(work / "reference.npz")), port, inp


def _block(a, spec, mesh, coords):
    return sharding.local_block(torch.from_numpy(np.ascontiguousarray(a)), tuple(spec), mesh, coords).numpy()


def _ranks(port, case):
    """(the case's mesh, each of its ranks' results with its coordinates)."""
    mesh = case["mesh"]
    results = port["2x4" if mesh == MESH else "pod"]
    return mesh, [(r, dict(zip(mesh, (int(c) for c in r["coords"])))) for r in results]


def _each_rank(runs, key, spec, tol, rtol=None):
    """Every rank's ``key`` against its block of the reference's sharded
    and naive outputs."""
    ref, port, _ = runs
    mesh, rs = _ranks(port, CASES[key.split("/")[0]])
    for r, coords in rs:
        got = r[key]
        for side in ("sharded", "naive"):
            want = _block(ref[f"{side}/{key}"], spec, mesh, coords)
            np.testing.assert_allclose(got, want, rtol=tol if rtol is None else rtol, atol=tol,
                                       err_msg=f"{key} ({side}) at {coords}")


def _cfg(key):
    c = CASES[key]
    return get_config(c["arch"], reduced=True).replace(**c["over"])


@pytest.mark.parametrize("key", _of("linear"))
def test_decode_attention_sharded_linear(runs, key):
    c = CASES[key]
    specs = attention.decode_attention_specs(_cfg(key), c["mesh"], c["B"])
    for t in c["steps"]:
        _each_rank(runs, f"{key}/y{t}", specs["x"], 2e-4)
        for kv in "kv":
            _each_rank(runs, f"{key}/{kv}{t}", specs["cache"], 1e-6, rtol=1e-5)


def test_decode_attention_sharded_ring_across_the_wrap(runs):
    c = CASES["ring"]
    specs = attention.decode_attention_specs(_cfg("ring"), MESH, c["B"])
    for t in c["steps"]:
        _each_rank(runs, f"ring/y{t}", specs["x"], 3e-4)
        for kv in "kv":
            _each_rank(runs, f"ring/{kv}{t}", specs["cache"], 1e-6, rtol=1e-5)


@pytest.mark.parametrize("key", _of("mlp"))
def test_decode_mlp_sharded(runs, key):
    specs = attention.decode_mlp_specs(_cfg(key), CASES[key]["mesh"], CASES[key]["B"])
    _each_rank(runs, f"{key}/y", specs["x"], 2e-4)


def test_mla_decode_sharded(runs):
    from repro_torch.models.mla import mla_decode_specs

    c = CASES["mla"]
    specs = mla_decode_specs(_cfg("mla"), MESH, c["B"])
    for t in c["steps"]:
        _each_rank(runs, f"mla/y{t}", specs["x"], 3e-4)
        for name in ("c_kv", "k_rope"):
            _each_rank(runs, f"mla/{name}{t}", specs["cache"], 1e-6, rtol=1e-5)


def _moe_against_the_reference(runs, key, at):
    """Every rank's moe output (under ``at``), aux and gradients against
    the reference's a2a and gather, dropless."""
    ref, port, _ = runs
    cfg = _cfg(key)
    mesh, rs = _ranks(port, CASES[key])
    specs = moe.moe_a2a_specs(cfg, mesh)
    ep2d = specs["w_gate"][0] == ("model", "data")
    assert ep2d == (key != "moe_1d")

    def each_rank(name, spec, tol, rtol):
        for r, coords in rs:
            for side in ("sharded", "naive"):
                np.testing.assert_allclose(r[f"{at}/{name}"], _block(ref[f"{side}/{key}/{name}"], spec, mesh, coords),
                                           rtol=rtol, atol=tol, err_msg=f"{at}/{name} ({side}) at {coords}")

    each_rank("y", specs["x"], 2e-4, 2e-4)
    for r, _ in rs:
        for side in ("sharded", "naive"):
            np.testing.assert_allclose(r[f"{at}/aux"], ref[f"{side}/{key}/aux"], rtol=1e-3, atol=1e-5)
    leaves = [k[len(f"sharded/{key}/grad/"):] for k in ref if k.startswith(f"sharded/{key}/grad/")]
    assert sorted(leaves) == sorted(["router", "w_gate", "w_up", "w_down", "shared/w_gate", "shared/w_up",
                                     "shared/w_down"])
    for name in leaves:
        spec = specs["shared"][name.split("/")[1]] if name.startswith("shared/") else specs[name]
        each_rank(f"grad/{name}", spec, 5e-4, 5e-3)


@pytest.mark.parametrize("key", _of("moe"))
def test_moe_a2a_output_aux_and_gradients(runs, key):
    """The a2a dispatch (2-D EP: 8 experts over model × data, with a pod
    axis replicated over pods; 1-D EP: 12 over model, d ZeRO'd over data)
    against the reference's a2a and its gather, dropless (capacity factor
    64); aux from the mean over every rank of the mesh."""
    _moe_against_the_reference(runs, key, key)


@pytest.mark.parametrize("key", _of("moe"))
def test_moe_gather_dispatch_of_a_sharded_batch(runs, key):
    """The gather dispatch of the sharded batch through ``moe_layer`` under
    the placed mesh, on the a2a's layout (rows over the batch axes, S over
    'model'), against the same: global slots and capacity, aux from the
    global means, gradients through both exchanges."""
    _moe_against_the_reference(runs, key, f"{key}/gather")


def _spec(e):
    """A spec as JSON gives it back: lists for tuples."""
    return tuple(tuple(x) if isinstance(x, list) else x for x in e)


def _layer_calls(cfg, baseline: bool) -> list:
    """A decode step's layers by the way they run (``ranks.COUNTERS``):
    the sharded attention, MLP, MLA, expert dispatch, cross attention,
    RG-LRU and Mamba-2 bodies, or under the baseline every attention,
    cross and MLP layer gathered at use (the RG-LRU and Mamba-2 mixers
    too)."""
    fam, L = cfg.family, cfg.num_layers
    if fam == "dense":
        attn, mlps, cross, rec = L, L, 0, 0
    elif fam == "hybrid":
        attn, mlps, cross, rec = L // 3, L, 0, L - L // 3
    elif fam == "vlm":
        cross = L // cfg.cross_attn_every
        attn, mlps, rec = L - cross, L, 0
    else:                                   # encdec: a self and a cross block a layer
        attn, mlps, cross, rec = L, 2 * L, L, 0
    if baseline:
        return [0, 0, 0, 0, 0, 0, 0, attn + mlps + cross + rec]
    return [attn, mlps, 0, 0, cross, rec, 0, 0]


@pytest.mark.parametrize("key", _of("decode"))
def test_decode_step_under_the_mesh_equals_the_unsharded_step(runs, key):
    """build_serve_step's per-rank step: each rank's logits rows against
    the port's unsharded decode_step (run here) and the reference's, every
    layer through its sharded body (under ``REPRO_SHARDED_DECODE=0``
    gathered at use), and the cache blocks after the last step. Every
    rank holds the rules' blocks: the parameters cut as
    ``param_specs(..., serve=True)`` cuts them, the caches as
    ``cache_specs`` does."""
    ref, port, inp = runs
    c = CASES[key]
    cfg = _cfg(key)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, ranks._tree(inp, f"{key}/params/")))
    cache = {k: torch.from_numpy(a.copy()) for k, a in ranks._tree(inp, f"{key}/cache/").items()}
    mesh, rs = _ranks(port, c)
    rows = (attention._decode_bspec(mesh, c["B"]), None, None)
    for n, pos in enumerate(c["steps"]):
        own, cache = decode.decode_step(lm, torch.from_numpy(inp[f"{key}/tokens"][:, n:n + 1]), cache, pos)
        for r, coords in rs:
            got = r[f"{key}/logits{pos}"]
            np.testing.assert_allclose(got, _block(own.numpy(), rows, mesh, coords), rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(got, _block(ref[f"naive/{key}/logits{pos}"], rows, mesh, coords),
                                       rtol=2e-4, atol=2e-4)
    rules = sharding.cache_specs(mesh, abstract_cache(lm, c["B"], c["max_len"], frames=c.get("frames")), c["B"])
    pspecs = sharding.param_specs(mesh, lm, serve=True)
    for r, coords in rs:
        assert r[f"{key}/serve_calls"].tolist() == [_layer_calls(cfg, c.get("baseline", False))] * len(c["steps"])
        assert {k: _spec(e) for k, e in json.loads(str(r[f"{key}/param_specs"])).items()} == pspecs
        csh = json.loads(str(r[f"{key}/cache_specs"]))
        for k in cache:
            spec = _spec(csh[k])
            assert spec == rules[k], (k, spec, rules[k])
            np.testing.assert_allclose(r[f"{key}/cache_after/{k}"], _block(cache[k].numpy(), spec, mesh, coords),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{key} cache {k}")


@pytest.mark.parametrize("key", _of("cross_blocks"))
def test_init_cache_under_the_mesh_projects_the_rank_s_cross_blocks(runs, key):
    """``init_cache`` under the mesh from the rank's rows of the image
    embeddings or audio frames: each rank's cross K/V block (along N, or
    along D where the image tokens do not divide 'model'; whisper's
    encoder run on the rank's blocks) equals the same block of the
    unsharded ``init_cache``, and the cut is the rules'."""
    _, port, inp = runs
    c = CASES[key]
    cfg = _cfg(key)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, ranks._tree(inp, f"{key}/params/")))
    name = "image_embeds" if cfg.family == "vlm" else "audio_embeds"
    whole = decode.init_cache(lm, c["B"], c["max_len"], **{name: torch.from_numpy(inp[f"{key}/{name}"])})
    mesh, rs = _ranks(port, c)
    rules = sharding.cache_specs(mesh, whole, c["B"])
    want_dim = {"cross_vlm_n": 2, "cross_vlm_d": 4, "cross_encdec": 2}[key]
    for r, coords in rs:
        csh = json.loads(str(r[f"{key}/cache_specs"]))
        for k in ("cross_k", "cross_v"):
            spec = _spec(csh[k])
            assert spec == rules[k] and spec[want_dim] == "model", (k, spec)
            np.testing.assert_allclose(r[f"{key}/{k}"], _block(whole[k].numpy(), spec, mesh, coords), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{key} {k} at {coords}")


def test_refusals_under_a_placed_mesh(runs):
    """Nothing of these refuses any more: a cache the reference's
    ``cache_specs`` cuts on a stacked axis as long as the batch (4 layers
    L G L G at B 2: the rule takes the 2 periods for the batch) is cut on
    its batch dimension instead (ROADMAP C13), the gather dispatch of a
    sharded batch and the moe family's decode caches run."""
    for r, _ in _ranks(runs[1], CASES["refusals"])[1]:
        layout, gather, mla = (str(m) for m in r["refusals/messages"])
        assert layout == "" and gather == "" and mla == "", (layout, gather, mla)


@pytest.mark.parametrize("kind,pos", [("linear", -1), ("linear", 1024), ("linear", 5000), ("ring", -1),
                                      ("mla", -1), ("mla", 1024)])
def test_sharded_decode_refuses_a_position_outside_the_cache(kind, pos):
    """A linear cache's position lies in [0, S) of its global length S
    (a rank's 256 times 'model' 4), as the unsharded decode's: past S no
    rank owns the slot, so the token's key and value would be dropped. A
    ring takes any pos ≥ 0. The check comes before any collective."""
    key = "mla" if kind == "mla" else "linear"
    cfg = _cfg(key)
    x = torch.zeros(1, 1, cfg.d_model)
    with pspec.logical_axis_rules(MESH), pytest.raises(ValueError, match=f"pos {pos} outside"):
        if kind == "mla":
            from repro_torch.models.mla import mla_decode_sharded

            mla_decode_sharded({}, x, torch.zeros(1, 256, cfg.kv_lora_rank), torch.zeros(1, 256, cfg.qk_rope_head_dim),
                               pos, cfg, batch=2)
        else:
            kc = torch.zeros(1, 256, cfg.num_kv_heads, cfg.head_dim_)
            attention.decode_attention_sharded({}, x, kc, kc.clone(), pos, cfg, batch=2, ring=kind == "ring")


class _RefMesh:
    """A stand-in for a reference mesh: the helpers read its ``.shape`` only."""

    def __init__(self, shape):
        self.shape = dict(shape)


GRID = [dict(zip(axes, dims)) for axes, dims_list in (
    (("data", "model"), [(1, 1), (1, 2), (2, 1), (2, 4), (4, 2), (1, 8), (16, 16), (3, 4), (2, 3)]),
    (("pod", "data", "model"), [(2, 16, 16), (2, 2, 2), (1, 2, 4), (2, 1, 4), (3, 2, 2)]),
    (("model",), [(4,)])) for dims in dims_list]


@pytest.mark.parametrize("shape", GRID, ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
def test_applicability_and_layout_helpers_equal_the_reference(shape, monkeypatch):
    monkeypatch.delenv("REPRO_SHARDED_DECODE", raising=False)
    cfg, ref_cfg = get_config("deepseek-v2-236b", reduced=True), ref_get_config("deepseek-v2-236b", reduced=True)
    with pspec.logical_axis_rules(dict(shape)), ref_pspec.logical_axis_rules(_RefMesh(shape)):
        assert attention.sharded_decode_on()
        for S in (1, 64, 127, 128, 256, 500, 512, 1024, 4096, 8192):
            for E in (1, 4, 8, 12, 160, 256):
                assert (moe._a2a_applicable(cfg.replace(num_experts=E), S)
                        == ref_moe._a2a_applicable(ref_cfg.replace(num_experts=E), S)), (S, E)
        for B in (1, 2, 3, 4, 8, 16, 64, 256):
            assert attention._decode_bspec(shape, B) == ref_attention._decode_bspec(_RefMesh(shape), B), B
        # the reference's baseline switch turns the port's sharded bodies off too
        monkeypatch.setenv("REPRO_SHARDED_DECODE", "0")
        assert not attention.sharded_decode_on() and not ref_attention._sharded_mlp_applicable()
        assert not ref_attention._sharded_decode_applicable(4096)
    assert pspec.current_mesh() is None


def _tiles(x: torch.Tensor, spec: tuple, mesh: dict) -> bool:
    """The distinct blocks of the ranks of ``mesh`` under ``spec`` hold every
    element of x once."""
    seen, parts = set(), []
    for flat_rank in range(math.prod(mesh.values())):
        coords, rest = {}, flat_rank
        for ax in reversed(list(mesh)):
            coords[ax], rest = rest % mesh[ax], rest // mesh[ax]
        where = tuple(sharding.block_index(mesh, e, coords) for e in spec)
        if where not in seen:
            seen.add(where)
            parts.append(sharding.local_block(x, spec, mesh, coords).reshape(-1))
    got = torch.sort(torch.cat(parts)).values
    return torch.equal(got, torch.arange(x.numel(), dtype=got.dtype))


@pytest.mark.parametrize("arch", list_archs())
def test_local_block_tiles_every_param_and_cache_spec(arch):
    """At mesh (2, 4), every spec param_specs (training and serving) and
    cache_specs give the reduced configuration's parameters and caches."""
    cfg = get_config(arch, reduced=True)
    lm = LM(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    for serve in (False, True):
        for name, spec in sharding.param_specs(MESH, shapes, serve=serve).items():
            x = torch.arange(math.prod(shapes[name]), dtype=torch.float64).reshape(shapes[name])
            assert _tiles(x, spec, MESH), (name, spec)
    B = 4
    cache = abstract_cache(lm, B, 64)
    specs = sharding.cache_specs(MESH, cache, B)

    def walk(tree, sp):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, sp[k])
            else:
                x = torch.arange(v.numel(), dtype=torch.float64).reshape(v.shape)
                assert _tiles(x, sp[k], MESH), (k, sp[k])

    walk(cache, specs)


def test_local_block_follows_the_tuple_order():
    """P(("model", "data")) is model-major, P(("pod", "data")) pod-major."""
    mesh = {"pod": 2, "data": 2, "model": 3}
    x = torch.arange(12)
    for coords in ({"pod": p, "data": d, "model": m} for p in range(2) for d in range(2) for m in range(3)):
        assert sharding.local_block(x, (("model", "data"),), mesh, coords).tolist() == \
            x[(coords["model"] * 2 + coords["data"]) * 2:][:2].tolist()
        assert sharding.local_block(x, (("pod", "data"),), mesh, coords).tolist() == \
            x[(coords["pod"] * 2 + coords["data"]) * 3:][:3].tolist()
    with pytest.raises(ValueError, match="does not divide"):
        sharding.local_block(torch.arange(10), ("model",), mesh, {"model": 0})
