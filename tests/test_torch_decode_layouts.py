"""The decode step under a mesh reads every cache layout that the sharding
rules give, on the CPU.

``runtime.sharding.cache_spec`` cuts each cache's batch dimension over
the batch axes where they divide it, then its longest remaining dimension
that divides 'model' over 'model'. Short caches and large batches on a
TP-only mesh so cut a self-attention cache along D or along its rows,
MLA's ``c_kv`` along its latent dimension (with ``k_rope`` along S, its
rows or its rope dimension) or both latent caches along their rows, and
the RG-LRU's and Mamba-2's caches along their rows.

(a) A spec-only sweep over the catalog, published and reduced widths,
'model' 2-16 × 'data' 1-4 (and two meshes with a pod axis), B 1-512 and
max_len 8-4,096: every layer's layout (``decode.layouts``) is one that a
sharded body reads (``decode.reads``, the predicate the step's ``_Rank``
checks).

(b) Parity of ``build_serve_step(..., mesh=...)`` on gloo ranks against
the reference's own ``build_serve_step(lm, mesh, B, max_len)`` under the
mesh (``_jax_sharded_reference.serve``, in a subprocess under eight
forced host devices, at the same time as the ranks), one reduced case per
layout the sweep finds, from random caches and parameters drawn from a
seed: each rank's logits rows within 2e-4 of the reference's and of the
port's unsharded step, its cache blocks after the last step within 1e-5,
its parameter and cache storage equal to the rules' bytes
(``launch.dryrun.argument_bytes``), and every layer through its sharded
body, none gathered at use.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.dryrun import argument_bytes
from repro_torch.models import LM, decode
from repro_torch.models.attention import _decode_bspec
from repro_torch.runtime import sharding
from repro_torch.runtime.serve import abstract_cache

import _torch_sharded_train_ranks as ranks
from _torch_sharded_ranks import COUNTERS, _at, _walk, cross_inputs

F32 = dict(param_dtype="float32", compute_dtype="float32")
MLA512 = dict(F32, kv_lora_rank=512)           # the published latent rank over reduced widths
ROW = {"data": 1, "model": 4}                  # TP only: the batch is free for 'model'
SQUARE = {"data": 2, "model": 2}
POD = {"pod": 2, "data": 2, "model": 2}
# each case: the layout it is there for, group of layers → (kind, layout) as ``decode.layouts`` gives it
CASES = {
    # reduced gemma2-9b (head_dim 32): every cache along D at max_len 8, along its rows at B 64
    "dense_d": dict(kind="serve", arch="gemma2-9b", over=F32, mesh=ROW, B=2, max_len=8, steps=[0, 1, 7], seed=41,
                    want={"local": ("self", (3,)), "global": ("self", (3,))}),
    "dense_rows": dict(kind="serve", arch="gemma2-9b", over=F32, mesh=ROW, B=64, max_len=16, steps=[0, 1, 15],
                       seed=42, want={"local": ("self", (0,)), "global": ("self", (0,))}),
    # reduced recurrentgemma-2b's 16-slot ring along D (across its wrap), and at B 128 along its rows with the
    # RG-LRU's h and conv
    "ring_d": dict(kind="serve", arch="recurrentgemma-2b", over=F32, mesh=ROW, B=4, max_len=16,
                   steps=[0, 1, 15, 16, 17, 40], seed=43,
                   want={"ring": ("self", (3,)), "rec": ("rglru", (1, 1, 2)), "extra": ("rglru", (1, 1, 2))}),
    "ring_rows": dict(kind="serve", arch="recurrentgemma-2b", over=F32, mesh=ROW, B=128, max_len=16,
                      steps=[0, 1, 16, 17], seed=44,
                      want={"ring": ("self", (0,)), "rec": ("rglru", (1, 0, 0)), "extra": ("rglru", (1, 0, 0))}),
    # whisper's decoder self caches along D (the cross caches too)
    "whisper_d": dict(kind="serve", arch="whisper-base", over=dict(F32, num_layers=2), mesh=ROW, B=4, max_len=16,
                      steps=[0, 1, 15], seed=45, want={"self": ("self", (3,)), "cross": ("cross", (3,))}),
    # MLA at the published kv_lora_rank 512: c_kv along r with k_rope along S (ROADMAP C14's input), its rows,
    # its rope dimension (2 x 2 x 2); and at the reduced rank both along their rows
    "mla_r_s": dict(kind="serve", arch="deepseek-v2-236b", over=MLA512, mesh=SQUARE, B=4, max_len=256,
                    steps=[0, 1, 200], seed=46, want={"dense": ("mla", (2, 1)), "moe": ("mla", (2, 1))}),
    "mla_r_rows": dict(kind="serve", arch="deepseek-v2-236b", over=MLA512, mesh=ROW, B=64, max_len=16,
                       steps=[0, 1, 15], seed=47, want={"dense": ("mla", (2, 0)), "moe": ("mla", (2, 0))}),
    "mla_r_rope": dict(kind="serve", arch="deepseek-v2-236b", over=MLA512, mesh=POD, B=4, max_len=8, steps=[0, 1, 7],
                       seed=48, want={"dense": ("mla", (2, 2)), "moe": ("mla", (2, 2))}),
    "mla_rows": dict(kind="serve", arch="deepseek-v2-236b", over=F32, mesh=ROW, B=64, max_len=16, steps=[0, 1, 15],
                     seed=49, want={"dense": ("mla", (0, 0)), "moe": ("mla", (0, 0))}),
    # reduced mamba2 at B 320: conv (B, 3, 288) and the state along their rows, conv_w cut by its channels
    "mamba_rows": dict(kind="serve", arch="mamba2-780m", over=dict(F32, num_layers=2), mesh=ROW, B=320, max_len=8,
                       steps=[0, 1, 2], seed=50, want={"mamba": ("mamba", (1, 0, 0))}),
}
MESHES = {"1x4": ROW, "2x2": SQUARE, "pod": POD}
LOGITS_TOL = 2e-4                              # the reference's decode tolerance
CACHE_TOL = 1e-5

# (a)'s grid
SWEEP_MESHES = [{"data": d, "model": m} for m in (2, 4, 8, 16) for d in (1, 2, 4)] + \
               [{"pod": 2, "data": 2, "model": 2}, {"pod": 2, "data": 1, "model": 4}]
SWEEP_B = (1, 2, 3, 4, 16, 64, 100, 128, 320, 500, 512)
SWEEP_LEN = (8, 16, 32, 64, 100, 256, 500, 512, 4096)
# the layouts outside S and channels that the bodies read: each is one the rules give in the sweep
NEW = {("self", (0,)), ("self", (3,)), ("mla", (0, 0)), ("mla", (2, 0)), ("mla", (2, 1)), ("mla", (2, 2)),
       ("rglru", (1, 0, 0)), ("mamba", (1, 0, 0))}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as every CPU-heavy port test file (ROADMAP C3)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _cfg(key):
    c = CASES[key]
    return get_config(c["arch"], reduced=True).replace(**c["over"])


def test_every_layout_the_rules_give_is_read():
    """(a) Over the catalog at published and reduced widths, 'model' 2, 4,
    8, 16 × 'data' 1, 2, 4 and two pod meshes, B 1-512 and max_len
    8-4,096 (100 and 500 among them): every group of layers of the
    decode step is laid out as a sharded body reads it, and the layouts
    outside S and channels all arise."""
    found: dict = {}
    for arch in ARCHS:
        for reduced in (False, True):
            cfg = get_config(arch, reduced=reduced)
            lm = LM(cfg, device="meta")
            layers = {tuple(m.items()): decode.layer_specs(sharding.param_specs(m, lm, serve=True)) for m in SWEEP_MESHES}
            for B in SWEEP_B:
                for max_len in SWEEP_LEN:
                    tree = abstract_cache(lm, B, max_len)
                    for mesh in SWEEP_MESHES:
                        cspecs = decode.cache_blocks(lm, B, max_len, mesh=mesh, abstract=tree)
                        for group, (kind, lay) in decode.layouts(cfg, cspecs, layers[tuple(mesh.items())],
                                                                 mesh).items():
                            found.setdefault((kind, lay), (arch, reduced, mesh, B, max_len, group))
    unread = {k: at for k, at in found.items() if not decode.reads(*k)}
    assert not unread, unread
    assert NEW <= set(found), NEW - set(found)


# ordinary short-context or large-batch inputs at published widths whose caches the rules cut otherwise than
# along S: (arch, B, max_len, mesh, the layouts they give)
PUBLISHED = {
    "gemma2_d": ("gemma2-9b", 8, 128, ROW, {"local": ("self", (3,)), "global": ("self", (3,))}),
    "gemma2_rows": ("gemma2-9b", 512, 128, ROW, {"local": ("self", (0,)), "global": ("self", (0,))}),
    "deepseek_c14": ("deepseek-v2-236b", 4, 256, SQUARE, {"dense": ("mla", (2, 1)), "moe": ("mla", (2, 1))}),
    "whisper_d": ("whisper-base", 4, 32, ROW, {"self": ("self", (3,)), "cross": ("cross", (3,))}),
    "recurrentgemma_d": ("recurrentgemma-2b", 8, 128, ROW, {"ring": ("self", (3,)), "rec": ("rglru", (1, 1, 2)),
                                                            "extra": ("rglru", (1, 1, 2))}),
}


@pytest.mark.parametrize("key", list(PUBLISHED))
def test_published_short_and_wide_inputs_run_on_meta(key):
    """Rank 0's decode step at published width on ``meta``
    (``launch.dryrun.analyze_rank_step``): it runs through the sharded
    bodies, holds exactly the rules' bytes and gathers no parameter
    block."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import dryrun

    arch, B, max_len, mesh, want = PUBLISHED[key]
    cfg = get_config(arch)
    lm = LM(cfg, device="meta")
    cspecs = decode.cache_blocks(lm, B, max_len, mesh=mesh)
    assert decode.layouts(cfg, cspecs, decode.layer_specs(sharding.param_specs(mesh, lm, serve=True)), mesh) == want
    _, coll, whole, held, _, _, _ = dryrun.analyze_rank_step(cfg, Shape("decode_32k", max_len, B, "decode"), mesh)
    assert held == argument_bytes(mesh, whole, "decode")
    assert coll["parameter_gathers"] == []


def _inputs() -> dict:
    inp = {}
    for key, c in CASES.items():
        cfg = _cfg(key)
        inp |= {f"{key}/params/{k}": v for k, v in ranks.reference_tree(cfg, c["seed"]).items()}
        rng = np.random.default_rng(c["seed"])
        cache = decode.init_cache(LM(cfg, device="meta"), c["B"], c["max_len"], **cross_inputs(cfg, c, c["B"], "meta"))
        for k, t in _walk(cache):
            inp[f"{key}/cache/{k}"] = (rng.standard_normal(tuple(t.shape)) * 0.5).astype(np.float32)
        inp[f"{key}/tokens"] = rng.integers(0, cfg.vocab_size, (c["B"], len(c["steps"]))).astype(np.int32)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, each mesh's ranks' results, the inputs): the
    reference subprocess and the ranks run at the same time."""
    inp = _inputs()
    ref, port = ranks.run_with_reference(tmp_path_factory.mktemp("decode_layouts"), CASES, inp, MESHES)
    return ref, port, inp


def _spec(e):
    """A spec as JSON gives it back: lists for tuples."""
    return tuple(tuple(x) if isinstance(x, list) else x for x in e)


def _nested(inp, key) -> dict:
    cache: dict = {}
    for k in (k[len(f"{key}/cache/"):] for k in inp if k.startswith(f"{key}/cache/")):
        *path, leaf = k.split("/")
        node = cache
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(inp[f"{key}/cache/{k}"].copy())
    return cache


@pytest.mark.parametrize("key", list(CASES))
def test_decode_step_reads_the_layout_where_it_lies(runs, key):
    """(b) Each rank's logits rows within 2e-4 of the reference's own serve
    step under the mesh and of the port's unsharded decode step, its cache
    blocks after the last step within 1e-5 of both; its blocks the rules'
    (specs and bytes); the case's layout the one it is there for; every
    layer through its sharded body."""
    ref, port, inp = runs
    c, cfg = CASES[key], _cfg(key)
    mesh = c["mesh"]
    lm = ranks.model(cfg, inp, key)
    cache = _nested(inp, key)
    rows = (_decode_bspec(mesh, c["B"]), None, None)
    name = next(n for n, m in MESHES.items() if m == mesh)
    rs = [(r, dict(zip(mesh, (int(x) for x in r["coords"])))) for r in port[name]]
    for n, pos in enumerate(c["steps"]):
        own, cache = decode.decode_step(lm, torch.from_numpy(inp[f"{key}/tokens"][:, n:n + 1]), cache, pos)
        for r, coords in rs:
            for whole in (own.numpy(), ref[f"serve/{key}/logits{pos}"]):
                np.testing.assert_allclose(r[f"{key}/logits{pos}"], ranks.cut(whole, rows, mesh, coords),
                                           rtol=LOGITS_TOL, atol=LOGITS_TOL, err_msg=f"{key} step {pos} at {coords}")
    tree = abstract_cache(lm, c["B"], c["max_len"])
    pspecs = sharding.param_specs(mesh, lm, serve=True)
    cspecs = decode.cache_blocks(lm, c["B"], c["max_len"], mesh=mesh, abstract=tree)
    assert decode.layouts(cfg, cspecs, decode.layer_specs(pspecs), mesh) == c["want"]
    rules = argument_bytes(mesh, {"params": dict(lm.named_parameters()), "cache": tree,
                                  "batch": {"tokens": torch.empty((c["B"], 1), dtype=torch.int32)}}, "decode")
    for r, coords in rs:
        calls = dict(zip(COUNTERS, np.asarray(r[f"{key}/serve_calls"]).sum(axis=0).tolist()))
        assert calls["gathered"] == 0, calls
        assert (calls["mlp"] > 0) == (cfg.family != "ssm"), calls
        assert (calls["attention"] > 0) == (cfg.family not in ("moe", "ssm")), calls
        assert (calls["mla"] > 0) == (cfg.family == "moe") and (calls["mamba"] > 0) == (cfg.family == "ssm"), calls
        assert (calls["rglru"] > 0) == (cfg.family == "hybrid"), calls
        assert {k: _spec(e) for k, e in json.loads(str(r[f"{key}/param_specs"])).items()} == pspecs
        assert r[f"{key}/held"].tolist() == [rules["params"], rules["cache"]], (coords, rules)
        csh = json.loads(str(r[f"{key}/cache_specs"]))
        for k, t in _walk(cache):
            spec = _spec(_at(csh, k))
            assert spec == _at(cspecs, k), (k, spec)
            for whole in (t.numpy(), ref[f"serve/{key}/cache_after/{k}"]):
                np.testing.assert_allclose(r[f"{key}/cache_after/{k}"], ranks.cut(whole, spec, mesh, coords),
                                           rtol=CACHE_TOL, atol=CACHE_TOL, err_msg=f"{key} cache {k} at {coords}")
