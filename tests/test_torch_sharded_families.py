"""The hybrid, vlm and encdec families' sharded training and prefill steps
on ``torch.distributed`` against the reference's own sharded steps, on the
CPU.

As ``test_torch_sharded_train.py`` does for the dense family: the
reference's ``build_train_step(lm, mesh, tcfg)`` and
``build_prefill_step(lm, mesh)`` in a subprocess under eight forced host
devices (``tests/_jax_sharded_train_reference.py``), the port on eight
spawned gloo ranks on a mesh of the same shape
(``tests/_torch_sharded_train_ranks.py``), the two at once, on the same
inputs: the reference's parameter tree of a model the port initialises
from a seed, the cross layers' tanh gates set to ``linspace(0.3, 0.9)``
(at the reference's init of 0 a cross layer adds nothing and its
projections get no gradient), and batches drawn with NumPy from a seed,
with image or audio embeddings. Cases, each 3 steps at B 8 × S 32:
reduced recurrentgemma-2b on 2 × 4 (window 8, adamw, 2 microbatches: a
rank has 1 of 4 heads, the kv head whole, 32 of 128 RG-LRU channels);
reduced llama-3.2-vision-11b with 8 layers, a cross layer every 4 and 2 kv
heads on 2 × 2 × 2 with a pod axis (adamw8: the stacked cross gates
quantized as one leaf); reduced whisper-base on 2 × 4 with remat (adamw,
2 microbatches: the audio embeddings regathered and cut with the rows);
each family's prefill step on 2 × 4; ``rglru_sharded`` at a width that
does not divide 'model'; and each family's decode through
``build_serve_step(..., mesh=...)`` against the reference's own
``build_serve_step(lm, mesh, B, max_len)`` (``_jax_sharded_reference.serve``)
from random caches: the hybrid's 64-slot ring at 16 slots a rank (S/m <
128, the key-range path) across its wrap; the vlm's cross K/V cut along N
(64 image tokens, 2 × 4), along D (17, 2 × 2 × 2) and along the rows over
'model' (1 × 4, B 64); whisper's along N (64 frames); and reduced
nemotron at 2 × 2 × 2 with B 4 = 4 layers (ROADMAP C13), its caches cut
on their batch dimension where the reference's rule takes the layer
axis.

Held to the dense family's limits: each step's loss and grad norm within
1e-5 relative of the reference's and of the port's unsharded step, the
learning rate equal; every rank's parameter blocks by
``assert_within_change``; the adamw8 codes and scales; the prefill's
logits rows within 1e-4 of the largest logit; the decode's logits rows
within 2e-4 and its cache blocks within 1e-5 of the reference's serve step
and of the port's unsharded decode step, every rank holding the rules'
blocks and every layer through its sharded body.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import LM, decode, params_from_reference, rglru
from repro_torch.models.attention import _decode_bspec
from repro_torch.models.interop import opt_state_from_reference
from repro_torch.runtime import sharding
from repro_torch.runtime.serve import abstract_cache
from repro_torch.runtime.train import build_prefill_step, build_train_step, init_opt_state

import _torch_sharded_train_ranks as ranks
from _torch_sharded_ranks import COUNTERS, _at, _walk, cross_inputs

MESH = {"data": 2, "model": 4}                 # the reference tests' mesh
POD = {"pod": 2, "data": 2, "model": 2}        # batch rows over (pod, data), parameters replicated over pods
F32 = dict(param_dtype="float32", compute_dtype="float32")
HYBRID = dict(F32, remat=False, local_window=8)                             # the window bites at 32 tokens
VLM = dict(F32, remat=False, num_layers=8, cross_attn_every=4, num_kv_heads=2)
WHISPER = dict(F32, remat=True)
VLM_SERVE = dict(F32, num_layers=8, cross_attn_every=4)
ROW = {"data": 1, "model": 4}                  # rows over 'model' where the batch is a cache's longest dimension
CASES = {
    "hybrid": dict(kind="train", arch="recurrentgemma-2b", over=HYBRID, mesh=MESH, B=8, S=32, steps=3,
                   tcfg=dict(ranks.TCFG, microbatches=2, optimizer="adamw"), seed=21),
    "vlm": dict(kind="train", arch="llama-3.2-vision-11b", over=VLM, mesh=POD, B=8, S=32, steps=3,
                tcfg=dict(ranks.TCFG, microbatches=1, optimizer="adamw8"), seed=22),
    "whisper": dict(kind="train", arch="whisper-base", over=WHISPER, mesh=MESH, B=8, S=32, steps=3,
                    tcfg=dict(ranks.TCFG, microbatches=2, optimizer="adamw"), seed=23),
    "hybrid_prefill": dict(kind="prefill", arch="recurrentgemma-2b", over=HYBRID, mesh=MESH, B=8, S=32, seed=24),
    "vlm_prefill": dict(kind="prefill", arch="llama-3.2-vision-11b", over=VLM, mesh=MESH, B=8, S=32, seed=25),
    "whisper_prefill": dict(kind="prefill", arch="whisper-base", over=WHISPER, mesh=MESH, B=8, S=32, seed=26),
    # 30 channels do not divide 'model' (4): the block runs whole
    "rglru_whole": dict(kind="rglru_whole", arch="recurrentgemma-2b", over=dict(F32, lru_width=30), mesh=MESH, B=8,
                        S=32, seed=27),
    # the decode through build_serve_step under the mesh, against the reference's own serve step: the hybrid's
    # 64-slot ring at 16 slots a rank (S/m < 128) across its wrap, h and conv by channels
    "hybrid_serve": dict(kind="serve", arch="recurrentgemma-2b", over=dict(F32, local_window=64), mesh=MESH, B=4,
                         max_len=256, steps=[0, 1, 63, 64, 65, 200], seed=28),
    # vlm cross K/V cut along N (64 image tokens), along D (17 do not divide 'model'), and along the rows over
    # 'model' (1 × 4, B 64 the longest dimension)
    "vlm_serve": dict(kind="serve", arch="llama-3.2-vision-11b", over=dict(VLM_SERVE, num_image_tokens=64), mesh=MESH,
                      B=4, max_len=256, steps=[0, 1, 200], seed=29),
    "vlm_serve_d": dict(kind="serve", arch="llama-3.2-vision-11b", over=dict(VLM_SERVE, num_image_tokens=17),
                        mesh=POD, B=4, max_len=256, steps=[0, 1, 200], seed=30),
    "vlm_serve_rows": dict(kind="serve", arch="llama-3.2-vision-11b", over=dict(VLM_SERVE, num_image_tokens=16),
                           mesh=ROW, B=64, max_len=128, steps=[0, 1, 100], seed=31),
    # whisper's cross K/V over 64 frames cut along N
    "whisper_serve": dict(kind="serve", arch="whisper-base", over=dict(F32, num_layers=3), mesh=MESH, B=4,
                          max_len=256, steps=[0, 1, 200], frames=64, seed=32),
    # ROADMAP C13: 4 layers at B 4 on 2 × 2 × 2, the reference's rule cuts the layer axis; the port the batch
    "c13_serve": dict(kind="serve", arch="nemotron-4-15b", over=F32, mesh=POD, B=4, max_len=256, steps=[0, 1, 200],
                      seed=33),
}
TRAIN = [k for k, c in CASES.items() if c["kind"] == "train"]
PREFILL = [k for k, c in CASES.items() if c["kind"] == "prefill"]
SERVE = [k for k, c in CASES.items() if c["kind"] == "serve"]
MESHES = {"2x4": MESH, "pod": POD, "1x4": ROW}
GATES = ("cross_blocks/xgate", "dec_cross/xgate")
LOSS_RTOL = 1e-5
LOGITS_TOL = 1e-4                              # of the largest |logit|


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


def _inputs() -> dict:
    inp = {}
    for key, c in CASES.items():
        cfg = _cfg(key)
        if c["kind"] == "rglru_whole":
            p = rglru.init_rglru(cfg, "cpu")
            rglru.init_rglru_(p, cfg, torch.Generator().manual_seed(c["seed"]))
            rng = np.random.default_rng(c["seed"])
            inp |= {f"{key}/mix/{k}": t.detach().numpy().copy() for k, t in p.items()}
            inp[f"{key}/mix/conv_b"] = (rng.standard_normal(cfg.lru_width_) * 0.1).astype(np.float32)
            inp[f"{key}/x"] = rng.standard_normal((c["B"], c["S"], cfg.d_model)).astype(np.float32)
            continue
        tree = ranks.reference_tree(cfg, c["seed"])
        for g in GATES:
            if g in tree:
                tree[g] = np.linspace(0.3, 0.9, tree[g].size, dtype=np.float32).reshape(tree[g].shape)
        inp |= {f"{key}/params/{k}": v for k, v in tree.items()}
        if c["kind"] == "serve":
            rng = np.random.default_rng(c["seed"])
            cache = decode.init_cache(LM(cfg, device="meta"), c["B"], c["max_len"],
                                      **cross_inputs(cfg, c, c["B"], "meta"))
            for k, t in _walk(cache):
                inp[f"{key}/cache/{k}"] = (rng.standard_normal(tuple(t.shape)) * 0.5).astype(np.float32)
            inp[f"{key}/tokens"] = rng.integers(0, cfg.vocab_size, (c["B"], len(c["steps"]))).astype(np.int32)
            continue
        for s, b in enumerate(ranks.batches(cfg, c["B"], c["S"], c.get("steps", 1), c["seed"])):
            inp |= {f"{key}/{n}{s}": a for n, a in b.items()}
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, each mesh's ranks' results, the inputs): the
    reference subprocess and the ranks run at the same time."""
    inp = _inputs()
    ref, port = ranks.run_with_reference(tmp_path_factory.mktemp("sharded_families"), CASES, inp, MESHES)
    return ref, port, inp


def _ranks(port, case):
    """Each rank's results of the case's mesh, with its coordinates."""
    mesh = case["mesh"]
    name = next(n for n, m in MESHES.items() if m == mesh)
    return [(r, dict(zip(mesh, (int(c) for c in r["coords"])))) for r in port[name]]


_UNSHARDED: dict = {}


def _unsharded(key, inp):
    """The port's own one-process step on the same inputs: (metrics, the
    parameters before, after, the optimizer state), computed once."""
    if key not in _UNSHARDED:
        c, cfg = CASES[key], _cfg(key)
        lm = ranks.model(cfg, inp, key)
        before = {k: p.detach().clone() for k, p in lm.named_parameters()}
        tcfg = ranks.tcfg_of(c)
        step = build_train_step(lm, tcfg)
        opt = init_opt_state(lm, tcfg.optimizer)
        metrics = []
        for s in range(c["steps"]):
            m = step(opt, ranks.batch_of(inp, key, s))
            metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
        _UNSHARDED[key] = (np.asarray(metrics), before, {k: p.detach().clone() for k, p in lm.named_parameters()},
                           opt)
    return _UNSHARDED[key]


@pytest.mark.parametrize("key", TRAIN)
def test_train_step_metrics_equal_the_reference(runs, key):
    """Loss and grad norm within 1e-5 relative at each step, of the
    reference's sharded step and the port's unsharded one; the learning
    rate equal (0 at step 0, in warmup)."""
    ref, port, inp = runs
    own = _unsharded(key, inp)[0]
    want = ref[f"{key}/metrics"]
    assert want[0, 2] == 0.0 and want[1, 2] > 0
    for r, coords in _ranks(port, CASES[key]):
        got = r[f"{key}/metrics"]
        for other in (want, own):
            np.testing.assert_allclose(got[:, :2], other[:, :2], rtol=LOSS_RTOL, atol=0, err_msg=f"{key} {coords}")
            np.testing.assert_array_equal(got[:, 2].astype(np.float32), other[:, 2].astype(np.float32))


@pytest.mark.parametrize("key", TRAIN)
def test_train_step_parameter_blocks_equal_the_reference(runs, key):
    """Every rank's block of every parameter after 3 steps against the same
    block of the reference's global parameters and of the port's unsharded
    step's, in units of the leaf's largest change (``assert_within_change``);
    every leaf moved, the cross layers' projections and gates too."""
    ref, port, inp = runs
    c, cfg = CASES[key], _cfg(key)
    _, before, after, _ = _unsharded(key, inp)
    want = params_from_reference(cfg, ranks.tree_of(ref, f"{key}/params/"))
    opt = c["tcfg"]["optimizer"]
    cut = 0
    for r, coords in _ranks(port, c):
        specs = json.loads(str(r[f"{key}/specs"]))["params"]
        for name, spec in specs.items():
            change = float((after[name] - before[name]).abs().max())
            assert change > 0, name
            got = r[f"{key}/params/{name}"]
            cut += any(e is not None for e in spec)
            for side, whole in (("reference", want[name]), ("unsharded", after[name])):
                ranks.assert_within_change(got, ranks.cut(whole.numpy(), spec, c["mesh"], coords), change, opt,
                                           f"{key} {name} ({side}) at {coords}")
    assert cut > 0


@pytest.mark.parametrize("key", TRAIN)
def test_gather_blocks_rebuilds_the_whole_parameters_on_one_rank(runs, key):
    """``gather_blocks`` of every rank's parameter blocks after the steps:
    the whole tensors on the first rank's host, each rank's block exactly
    its cut of them; None on every other rank."""
    c = CASES[key]
    rs = _ranks(runs[1], c)
    first = rs[0][0]
    assert bool(first[f"{key}/kept"]) and not any(bool(r[f"{key}/kept"]) for r, _ in rs[1:])
    specs = json.loads(str(first[f"{key}/specs"]))["params"]
    for r, coords in rs:
        for name, spec in specs.items():
            np.testing.assert_array_equal(r[f"{key}/params/{name}"],
                                          ranks.cut(first[f"{key}/whole/{name}"], spec, c["mesh"], coords))


def test_adamw8_codes_and_scales_equal_the_reference(runs):
    """The vlm case's moments (adamw8 on 2 × 2 × 2): every rank's block of
    each leaf's codes and scales against the reference's and the unsharded
    step's, within the limits of the dense family's test of the same name;
    the cross gates, 0-d and replicated, quantized as the reference's one
    stacked leaf."""
    ref, port, inp = runs
    key, c, cfg = "vlm", CASES["vlm"], _cfg("vlm")
    want = opt_state_from_reference(cfg, ranks.tree_of(ref, f"{key}/opt/") | {"step": np.asarray(3)}, "adamw8")
    own = _unsharded(key, inp)[3]
    gates = 0
    for r, coords in _ranks(port, c):
        specs = json.loads(str(r[f"{key}/specs"]))
        for mom in ("m", "v"):
            for name, spec in specs["opt"][mom].items():
                gates += name.endswith("xgate")
                for side, whole in (("reference", want[mom][name]), ("unsharded", own[mom][name])):
                    q = r[f"{key}/opt/{mom}/{name}/q"]
                    wq = ranks.cut(whole["q"].numpy(), spec["q"], c["mesh"], coords)
                    diff = np.abs(q.astype(np.int32) - wq.astype(np.int32))
                    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (side, mom, name, coords, diff.sum())
                    np.testing.assert_allclose(r[f"{key}/opt/{mom}/{name}/scale"],
                                               ranks.cut(whole["scale"].numpy(), spec["scale"], c["mesh"], coords),
                                               rtol=1e-2, atol=1e-4 * float(whole["scale"].abs().max()),
                                               err_msg=f"{side} {mom} {name} at {coords}")
    assert gates == 2 * 2 * len(_ranks(port, c))      # 2 gates, m and v, on every rank


@pytest.mark.parametrize("key", TRAIN)
def test_every_layer_runs_sharded(runs, key):
    """Each step runs every attention block (self and cross, the encoder's
    too), every MLP and every RG-LRU block through the sharded functions,
    once a microbatch (twice with remat: the recompute)."""
    c = CASES[key]
    cfg = _cfg(key)
    times = c["tcfg"]["microbatches"] * (2 if cfg.remat else 1)
    attn, mlp, rec = (n * times for n in ranks.sharded_layers(cfg))
    for r, _ in _ranks(runs[1], c):
        assert r[f"{key}/calls"].tolist() == [[attn, mlp]] * c["steps"]
        assert r[f"{key}/rglru_calls"].tolist() == [rec] * c["steps"]


@pytest.mark.parametrize("key", PREFILL)
def test_prefill_step_equals_the_reference(runs, key):
    """Each rank's rows of the (B, 1, V) logits within 1e-4 of the largest
    logit of the reference's sharded prefill and of the port's unsharded
    one, every attention and RG-LRU block run sharded once."""
    ref, port, inp = runs
    c, cfg = CASES[key], _cfg(key)
    batch = ranks.batch_of(inp, key, 0)
    batch.pop("labels")
    own = build_prefill_step(ranks.model(cfg, inp, key))(batch).numpy()
    want = ref[f"{key}/logits"]
    rows = (sharding.batch_specs(MESH, {"x": torch.empty(c["B"])})["x"][0], None, None)
    attn, _, rec = ranks.sharded_layers(cfg)
    for r, coords in _ranks(port, c):
        got = r[f"{key}/logits"]
        for whole in (want, own):
            np.testing.assert_allclose(got, ranks.cut(whole, rows, MESH, coords), rtol=0,
                                       atol=LOGITS_TOL * np.abs(whole).max())
        assert int(r[f"{key}/calls"]) == attn and int(r[f"{key}/rglru_calls"]) == rec


def test_rglru_sharded_runs_a_width_that_does_not_divide_whole(runs):
    """At 30 channels over 'model' 4 the rules leave the width whole (d is
    still cut over 'data'): each rank runs the whole block on its rows,
    equal to ``rglru_forward`` of the whole parameters."""
    c = CASES["rglru_whole"]
    for r, coords in _ranks(runs[1], c):
        specs = json.loads(str(r["rglru_whole/specs"]))
        assert "model" not in json.dumps(specs) and specs["w_x"] == ["data", None]
        assert int(r["rglru_whole/calls"]) == 1
        np.testing.assert_allclose(r["rglru_whole/got"], r["rglru_whole/want"], rtol=1e-6, atol=1e-6,
                                   err_msg=str(coords))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_row_parallel_rounds_the_summed_partials_once(dtype):
    """``layers.row_parallel`` keeps a rank's partial product in float32 and
    rounds the sum over 'model' once to the input's type (on one rank: the
    float32 product rounded once); its gradients are the plain product's,
    in the input's type."""
    from repro_torch.models.layers import row_parallel

    rng = np.random.default_rng(5)
    x, w, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
               for s in ((2, 7, 48), (48, 24), (2, 7, 24)))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = row_parallel(xa, wa, {"model": 1})
    assert y.dtype == dtype
    torch.testing.assert_close(y, (x.float() @ w.float()).to(dtype), rtol=0, atol=0)
    y.backward(g)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    torch.matmul(xb, wb).backward(g)
    torch.testing.assert_close(xa.grad, xb.grad, rtol=0, atol=0)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=0, atol=0)


def _spec(e):
    """A spec as JSON gives it back: lists for tuples."""
    return tuple(tuple(x) if isinstance(x, list) else x for x in e)


@pytest.mark.parametrize("key", SERVE)
def test_decode_step_under_the_mesh_equals_the_reference(runs, key):
    """``build_serve_step(..., mesh=...)``: each rank's logits rows against
    the reference's own serve step under the mesh and the port's unsharded
    decode step within 2e-4, and its cache blocks after the last step
    within 1e-5. Every rank holds the rules' blocks (``param_specs(...,
    serve=True)``; the caches ``cache_specs``', but for C13's: the batch
    dimension where the reference cuts a stacked axis as long as the
    batch, the same bytes) and runs every layer through its sharded body,
    none gathered at use."""
    ref, port, inp = runs
    c, cfg = CASES[key], _cfg(key)
    mesh = c["mesh"]
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, ranks.tree_of(inp, f"{key}/params/")))
    cache = {}
    for k in (k[len(f"{key}/cache/"):] for k in inp if k.startswith(f"{key}/cache/")):
        cache[k] = torch.from_numpy(inp[f"{key}/cache/{k}"].copy())
    rows = (_decode_bspec(mesh, c["B"]), None, None)
    rs = _ranks(port, c)
    for n, pos in enumerate(c["steps"]):
        own, cache = decode.decode_step(lm, torch.from_numpy(inp[f"{key}/tokens"][:, n:n + 1]), cache, pos)
        for r, coords in rs:
            got = r[f"{key}/logits{pos}"]
            for whole in (own.numpy(), ref[f"serve/{key}/logits{pos}"]):
                np.testing.assert_allclose(got, ranks.cut(whole, rows, mesh, coords), rtol=2e-4, atol=2e-4,
                                           err_msg=f"{key} step {pos} at {coords}")
    rules = sharding.cache_specs(mesh, abstract_cache(lm, c["B"], c["max_len"], frames=c.get("frames")), c["B"])
    pspecs = sharding.param_specs(mesh, lm, serve=True)
    moved = 0
    for r, coords in rs:
        calls = dict(zip(COUNTERS, np.asarray(r[f"{key}/serve_calls"]).sum(axis=0).tolist()))
        assert calls["gathered"] == 0 and calls["attention"] > 0 and calls["mlp"] > 0, calls
        assert (calls["cross"] > 0) == (cfg.family in ("vlm", "encdec")), calls
        assert (calls["rglru"] > 0) == (cfg.family == "hybrid"), calls
        assert {k: _spec(e) for k, e in json.loads(str(r[f"{key}/param_specs"])).items()} == pspecs
        csh = json.loads(str(r[f"{key}/cache_specs"]))
        for k, t in cache.items():
            spec, want = _spec(_at(csh, k)), rules[k]
            if spec != want:                          # C13: the batch's axes moved off a stacked layer axis
                moved += 1
                assert key == "c13_serve" and want[0] == spec[1] and spec[0] is None, (k, spec, want)
            for whole in (t.numpy(), ref[f"serve/{key}/cache_after/{k}"]):
                np.testing.assert_allclose(r[f"{key}/cache_after/{k}"], ranks.cut(whole, spec, mesh, coords),
                                           rtol=1e-5, atol=1e-5, err_msg=f"{key} cache {k} at {coords}")
    assert (moved > 0) == (key == "c13_serve")
    cross = {"vlm_serve": 2, "vlm_serve_d": 4, "vlm_serve_rows": 1, "whisper_serve": 2}.get(key)
    if cross is not None:                             # the cut each case is there for
        assert rules["cross_k"][cross] == "model", rules["cross_k"]
    if key == "hybrid_serve":
        assert rules["ring_k"][2] == "model" and rules["h"][3] == "model" and rules["conv"][4] == "model"
