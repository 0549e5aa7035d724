"""The moe family's sharded training, prefill and decode steps on
``torch.distributed`` against the reference's own sharded steps, on the
CPU.

As ``test_torch_sharded_families.py`` does for the hybrid, vlm and encdec
families: the reference's ``build_train_step(lm, mesh, tcfg)``,
``build_prefill_step(lm, mesh)`` and ``build_serve_step(lm, mesh, B,
max_len)`` in a subprocess under eight forced host devices
(``tests/_jax_sharded_train_reference.py``, the serve step through
``tests/_jax_sharded_reference.py``), the port on eight spawned gloo ranks
on a mesh of the same shape (``tests/_torch_sharded_train_ranks.py``), the
two at once, on the same inputs: the reference's parameter tree of a
model the port initialises from a seed and batches drawn with NumPy from
a seed. ``MOE_IMPL`` is set per case on both sides. Cases, float32, B 8 ×
S 32, 3 steps unless stated:

* reduced deepseek-v2-236b under "gather" on 2 × 4 at the published
  capacity factor 1.25, 2-D EP (one expert a rank), over a batch on which
  the reference's dispatch drops tokens: the global capacity and slots;
* the same with 12 experts (1-D EP: E over 'model', d ZeRO'd over 'data');
* reduced deepseek-v2-236b under "a2a" on 2 × 2 × 2 with a pod axis and
  adamw8, at the dropless cut (capacity factor 64), so that it also
  equals the unsharded step;
* reduced deepseek-v3-671b under "a2a" on 2 × 4, 2 steps, remat, at 1.25
  (the per-shard capacity of the reference's own a2a; the sigmoid
  router's bias, whose gradient is zero, decayed);
* the prefill on 2 × 4;
* the decode through ``build_serve_step`` on 2 × 4: B 16 over max_len
  1,024 from random caches, 3 steps, the routers scaled 4× so that some
  expert overflows the one-token step's capacity of 8.

Held to the dense family's limits: each step's loss and grad norm within
1e-5 relative of the reference's (and, under "gather" or dropless, of the
port's unsharded step), the learning rate equal; every rank's parameter blocks by
``assert_within_change``; the adamw8 codes and scales; the prefill's
logits rows within 1e-4 of the largest logit; the decode's within
``F32_TOL`` 2e-4. Every layer runs through the sharded MLA, the sharded
MLP and the dispatch under the mesh (their counters).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import LM, decode, moe, params_from_reference
from repro_torch.models.interop import opt_state_from_reference
from repro_torch.runtime import sharding
from repro_torch.runtime.train import build_prefill_step, build_train_step, init_opt_state

import _torch_sharded_train_ranks as ranks
from _torch_sharded_ranks import _at, _walk

MESH = {"data": 2, "model": 4}                 # the reference tests' mesh
POD = {"pod": 2, "data": 2, "model": 2}        # batch rows over (pod, data), parameters replicated over pods
F32 = dict(param_dtype="float32", compute_dtype="float32")
MOE = dict(F32, remat=False)
# The dropless cut (phase 12's and test_torch_sharded.py's): under the a2a's per-shard capacity a token
# at a shard's capacity is dropped or kept on a routing difference of a rounding, which the parameters'
# updates reach after a step (measured on this case at 1.25: one embedding element 0.026 of its leaf's
# change from the reference's; 0.0104 of it and 2 adamw8 codes apart with adamw8; dropless, within
# the dense family's limits of both the reference's and the unsharded step's).
DROPLESS = 64.0
TRAIN_TCFG = dict(ranks.TCFG, microbatches=1, optimizer="adamw")
CASES = {
    "v2_gather": dict(kind="train", arch="deepseek-v2-236b", over=MOE, mesh=MESH, B=8, S=32, steps=3,
                      tcfg=TRAIN_TCFG, moe_impl="gather", drops=True, seed=31),
    "v2_gather_e12": dict(kind="train", arch="deepseek-v2-236b", over=dict(MOE, num_experts=12), mesh=MESH, B=8,
                          S=32, steps=3, tcfg=TRAIN_TCFG, moe_impl="gather", drops=True, seed=32),
    "v2_a2a_pod": dict(kind="train", arch="deepseek-v2-236b", over=dict(MOE, capacity_factor=DROPLESS), mesh=POD, B=8, S=32, steps=3,
                       tcfg=dict(TRAIN_TCFG, optimizer="adamw8"), moe_impl="a2a", seed=33),
    "v3_a2a": dict(kind="train", arch="deepseek-v3-671b", over=dict(F32, remat=True), mesh=MESH, B=8, S=32, steps=2,
                   tcfg=TRAIN_TCFG, moe_impl="a2a", seed=34),
    "v2_prefill": dict(kind="prefill", arch="deepseek-v2-236b", over=MOE, mesh=MESH, B=8, S=32, seed=35),
    "v2_serve": dict(kind="serve", arch="deepseek-v2-236b", over=F32, mesh=MESH, B=16, max_len=1024,
                     steps=[0, 1, 700], router_scale=4.0, seed=36),
    # serving's ZeRO forced: the router's d over 'data' (its logits weight-stationary), the shared experts'
    # and MLA's input dimension over 'data' too
    "v2_serve_zero3": dict(kind="serve", arch="deepseek-v2-236b", over=F32, mesh=MESH, B=8, max_len=256,
                           steps=[0, 1, 200], serve_zero3_budget=0, seed=37),
}
TRAIN = [k for k, c in CASES.items() if c["kind"] == "train"]
GATHER = [k for k in TRAIN if CASES[k]["moe_impl"] == "gather"]
LOSS_RTOL = 1e-5
LOGITS_TOL = 1e-4                              # of the largest |logit|
F32_TOL = 2e-4                                 # the reference's decode tolerance
# adamw8 codes: a moment at a rounding boundary at step t takes the next code (1 apart, as the dense
# family's test allows); at t + 1 that code's difference is carried as β1 · scale_t / scale_t+1 codes,
# more than 1 where the block's scale shrank (measured 1.25: codes 39 | 40, then 17 | 18, then -21 | -19
# on a mamba2 embedding row whose scale went 9.69e-6, 1.28e-5, 9.28e-6), which rounds to 2
CODE_GAP = 2


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
        tree = ranks.reference_tree(cfg, c["seed"])
        if "router_scale" in c:
            for k in tree:
                if k.endswith("/router"):
                    tree[k] = tree[k] * np.float32(c["router_scale"])
        inp |= {f"{key}/params/{k}": v for k, v in tree.items()}
        if c["kind"] == "serve":
            rng = np.random.default_rng(c["seed"])
            cache = decode.init_cache(LM(cfg, device="meta"), c["B"], c["max_len"])
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
    ref, port = ranks.run_with_reference(tmp_path_factory.mktemp("sharded_moe"), CASES, inp,
                                         {"2x4": MESH, "pod": POD})
    return ref, port, inp


def _ranks(port, case):
    """Each rank's results of the case's mesh, with its coordinates."""
    mesh = case["mesh"]
    return [(r, dict(zip(mesh, (int(c) for c in r["coords"])))) for r in port["2x4" if mesh == MESH else "pod"]]


_UNSHARDED: dict = {}


def _unsharded(key, inp):
    """The port's own one-process step on the same inputs (the gather
    dispatch): (metrics, the parameters before, after, the optimizer
    state), computed once."""
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


def _sides(key, ref, inp):
    """What a train case is held to: the reference's sharded step, and the
    port's unsharded one where the dispatch is the gather's or nothing is
    dropped (the a2a's per-shard capacity is the reference's own
    semantics)."""
    dropless = CASES[key]["over"].get("capacity_factor", 0) >= DROPLESS
    return ["reference"] + (["unsharded"] if CASES[key]["moe_impl"] == "gather" or dropless else [])


@pytest.mark.parametrize("key", TRAIN)
def test_train_step_metrics_equal_the_reference(runs, key):
    """Loss and grad norm within 1e-5 relative at each step (the aux loss
    counted once), the learning rate equal (0 at step 0, in warmup)."""
    ref, port, inp = runs
    want = {"reference": ref[f"{key}/metrics"]}
    if "unsharded" in _sides(key, ref, inp):
        want["unsharded"] = _unsharded(key, inp)[0]
    assert want["reference"][0, 2] == 0.0 and want["reference"][1, 2] > 0
    for r, coords in _ranks(port, CASES[key]):
        got = r[f"{key}/metrics"]
        for side, other in want.items():
            np.testing.assert_allclose(got[:, :2], other[:, :2], rtol=LOSS_RTOL, atol=0,
                                       err_msg=f"{key} {side} {coords}")
            np.testing.assert_array_equal(got[:, 2].astype(np.float32), other[:, 2].astype(np.float32))


@pytest.mark.parametrize("key", TRAIN)
def test_train_step_parameter_blocks_equal_the_reference(runs, key):
    """Every rank's block of every parameter after the steps against the
    same block of the reference's global parameters (and of the unsharded
    step's), in units of the leaf's largest change
    (``assert_within_change``); every leaf moved, the experts and the
    router's bias too."""
    ref, port, inp = runs
    c, cfg = CASES[key], _cfg(key)
    _, before, after, _ = _unsharded(key, inp)
    want = {"reference": params_from_reference(cfg, ranks.tree_of(ref, f"{key}/params/"))}
    if "unsharded" in _sides(key, ref, inp):
        want["unsharded"] = after
    opt = c["tcfg"]["optimizer"]
    cut = 0
    for r, coords in _ranks(port, c):
        specs = json.loads(str(r[f"{key}/specs"]))["params"]
        for name, spec in specs.items():
            change = float((want["reference"][name] - before[name]).abs().max())
            assert change > 0, name
            got = r[f"{key}/params/{name}"]
            cut += any(e is not None for e in spec)
            for side, whole in want.items():
                ranks.assert_within_change(got, ranks.cut(whole[name].numpy(), spec, c["mesh"], coords), change, opt,
                                           f"{key} {name} ({side}) at {coords}")
    assert cut > 0


@pytest.mark.parametrize("key", TRAIN)
def test_gather_blocks_rebuilds_the_whole_parameters_on_one_rank(runs, key):
    """``gather_blocks`` of every rank's blocks: the whole tensors on the
    first rank's host, each rank's block exactly its cut of them."""
    c = CASES[key]
    rs = _ranks(runs[1], c)
    first = rs[0][0]
    assert bool(first[f"{key}/kept"]) and not any(bool(r[f"{key}/kept"]) for r, _ in rs[1:])
    specs = json.loads(str(first[f"{key}/specs"]))["params"]
    for r, coords in rs:
        for name, spec in specs.items():
            np.testing.assert_array_equal(r[f"{key}/params/{name}"],
                                          ranks.cut(first[f"{key}/whole/{name}"], spec, c["mesh"], coords))


def test_experts_are_cut_as_the_reference_cuts_them(runs):
    """2-D EP where the experts divide 'model' × 'data' (8 over 2 × 4, and
    over 2 × 2 replicated over pods), else E over 'model' and d over 'data'
    (12 experts): no rank holds every expert."""
    want = {"v2_gather": [["model", "data"], None, None], "v2_gather_e12": ["model", "data", None],
            "v2_a2a_pod": [["model", "data"], None, None], "v3_a2a": [["model", "data"], None, None]}
    for key, spec in want.items():
        for r, _ in _ranks(runs[1], CASES[key]):
            specs = json.loads(str(r[f"{key}/specs"]))["params"]
            assert specs["moe_blocks.0.moe.w_gate"] == spec, (key, specs["moe_blocks.0.moe.w_gate"])


def test_adamw8_codes_and_scales_equal_the_reference(runs):
    """The a2a case's moments (adamw8 on 2 × 2 × 2): every rank's block of
    each leaf's codes and scales against the reference's and the unsharded
    step's, within the limits of the dense family's test of the same name
    but the codes' gap, ``CODE_GAP``: at most 1% of a leaf's codes differ."""
    ref, port, inp = runs
    key, c, cfg = "v2_a2a_pod", CASES["v2_a2a_pod"], _cfg("v2_a2a_pod")
    want = opt_state_from_reference(cfg, ranks.tree_of(ref, f"{key}/opt/") | {"step": np.asarray(3)}, "adamw8")
    own = _unsharded(key, inp)[3]
    experts = 0
    for r, coords in _ranks(port, c):
        specs = json.loads(str(r[f"{key}/specs"]))
        for mom in ("m", "v"):
            for name, spec in specs["opt"][mom].items():
                experts += name.endswith("moe.w_gate")
                for side, whole in (("reference", want[mom][name]), ("unsharded", own[mom][name])):
                    q = r[f"{key}/opt/{mom}/{name}/q"]
                    wq = ranks.cut(whole["q"].numpy(), spec["q"], c["mesh"], coords)
                    diff = np.abs(q.astype(np.int32) - wq.astype(np.int32))
                    assert diff.max() <= CODE_GAP and (diff > 0).mean() <= 0.01, (side, mom, name, coords, diff.sum())
                    np.testing.assert_allclose(r[f"{key}/opt/{mom}/{name}/scale"],
                                               ranks.cut(whole["scale"].numpy(), spec["scale"], c["mesh"], coords),
                                               rtol=1e-2, atol=1e-4 * float(whole["scale"].abs().max()),
                                               err_msg=f"{side} {mom} {name} at {coords}")
    assert experts == 2 * 3 * len(_ranks(port, c))      # 3 moe layers, m and v, on every rank


def _layers(cfg):
    """(MLA blocks, dense MLPs, moe blocks) of one forward."""
    return cfg.num_layers, cfg.first_k_dense, cfg.num_layers - cfg.first_k_dense


@pytest.mark.parametrize("key", TRAIN)
def test_every_layer_runs_sharded(runs, key):
    """Each step runs every MLA block through ``mla_sharded``, the dense
    MLPs and the shared experts through ``mlp_sharded``, and every moe
    block through the case's dispatch under the mesh, once a microbatch
    (twice with remat: the recompute); nothing through the other
    families' sharded layers."""
    c, cfg = CASES[key], _cfg(key)
    times = c["tcfg"]["microbatches"] * (2 if cfg.remat else 1)
    L, dense, routed = _layers(cfg)
    gather = routed if c["moe_impl"] == "gather" else 0
    want = [0, (dense + routed) * times, 0, L * times, 0, gather * times, (routed - gather) * times]
    for r, _ in _ranks(runs[1], c):
        assert r[f"{key}/layer_calls"].tolist() == [want] * c["steps"], (ranks.LAYERS, r[f"{key}/layer_calls"])


@pytest.mark.parametrize("key", GATHER)
def test_the_gather_cases_drop_tokens(runs, key):
    """The reference's one-device dispatch drops (token, choice) pairs past
    the capacity on the case's first batch, and so does the port's
    dispatch of the sharded batch over the steps: the global capacity and
    slots count."""
    ref, port, _ = runs
    assert int(ref[f"{key}/drops"]) > 0
    for r, _ in _ranks(port, CASES[key]):
        assert int(r[f"{key}/dropped"]) > 0


def test_prefill_step_equals_the_reference(runs):
    """Each rank's rows of the (B, 1, V) logits within 1e-4 of the largest
    logit of the reference's sharded prefill and of the port's unsharded
    one, every MLA and moe block run sharded once."""
    ref, port, inp = runs
    key = "v2_prefill"
    c, cfg = CASES[key], _cfg(key)
    batch = ranks.batch_of(inp, key, 0)
    batch.pop("labels")
    own = build_prefill_step(ranks.model(cfg, inp, key))(batch).numpy()
    want = ref[f"{key}/logits"]
    rows = (sharding.batch_specs(MESH, {"x": torch.empty(c["B"])})["x"][0], None, None)
    L, dense, routed = _layers(cfg)
    for r, coords in _ranks(port, c):
        got = r[f"{key}/logits"]
        for whole in (want, own):
            np.testing.assert_allclose(got, ranks.cut(whole, rows, MESH, coords), rtol=0,
                                       atol=LOGITS_TOL * np.abs(whole).max())
        assert r[f"{key}/layer_calls"].tolist() == [0, dense + routed, 0, L, 0, routed, 0]


def test_decode_step_under_the_mesh_equals_the_reference(runs):
    """``build_serve_step(..., mesh=...)``: each rank's logits rows against
    the reference's own serve step under the mesh and the port's unsharded
    decode step within 2e-4, the latent caches after the last step; every
    MLA block through ``mla_decode_sharded`` (its caches cut over 'model'
    along S, as ``runtime.sharding.cache_specs`` cuts them), the dense MLP
    through the sharded MLP, every moe block through the gather dispatch
    of the sharded batch, which drops tokens (the reference's dispatch
    does too); the experts cut over 'model' × 'data'."""
    ref, port, inp = runs
    key = "v2_serve"
    c, cfg = CASES[key], _cfg(key)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, ranks.tree_of(inp, f"{key}/params/")))
    cache = {}
    for k in (k[len(f"{key}/cache/"):] for k in inp if k.startswith(f"{key}/cache/")):
        part, leaf = k.split("/")
        cache.setdefault(part, {})[leaf] = torch.from_numpy(inp[f"{key}/cache/{k}"].copy())
    from repro_torch.models.attention import _decode_bspec

    rows = (_decode_bspec(MESH, c["B"]), None, None)
    rs = _ranks(port, c)
    for n, pos in enumerate(c["steps"]):
        own, cache = decode.decode_step(lm, torch.from_numpy(inp[f"{key}/tokens"][:, n:n + 1]), cache, pos)
        for r, coords in rs:
            got = r[f"{key}/logits{pos}"]
            for whole in (own.numpy(), ref[f"serve/{key}/logits{pos}"]):
                np.testing.assert_allclose(got, ranks.cut(whole, rows, MESH, coords), rtol=F32_TOL, atol=F32_TOL)
    L, dense, routed = _layers(cfg)
    assert int(ref[f"serve/{key}/drops"]) > 0
    for r, coords in rs:
        assert int(r[f"{key}/dropped"]) > 0
        # attention, MLP (the dense layer's and each routed layer's shared experts), MLA, dispatch, cross,
        # RG-LRU, Mamba-2, gathered at use
        assert r[f"{key}/serve_calls"].tolist() == [[0, dense + routed, L, routed, 0, 0, 0, 0]] * len(c["steps"])
        csh = json.loads(str(r[f"{key}/cache_specs"]))
        psh = json.loads(str(r[f"{key}/param_specs"]))
        assert psh["moe_blocks.0.moe.w_gate"] == [["model", "data"], None, None]
        assert {k: tuple(tuple(x) if isinstance(x, list) else x for x in e) for k, e in psh.items()} == \
            sharding.param_specs(MESH, lm, serve=True)
        for k, t in _walk(cache):
            spec = tuple(tuple(e) if isinstance(e, list) else e for e in _at(csh, k))
            assert spec[2] == "model", (k, spec)
            for whole in (t.numpy(), ref[f"serve/{key}/cache_after/{k}"]):
                np.testing.assert_allclose(r[f"{key}/cache_after/{k}"], ranks.cut(whole, spec, MESH, coords),
                                           rtol=1e-5, atol=1e-5, err_msg=f"cache {k} at {coords}")


def test_decode_reads_latent_caches_cut_apart():
    """At the published kv_lora_rank 512 over max_len 256 on 2 × 2 the
    rules cut c_kv (L, B, 256, 512) along its latent dimension and k_rope
    (L, B, 256, 64) along S (ROADMAP C14). The decode step reads that pair
    where it lies: rank 0's step runs on ``meta``, every MLA layer through
    ``mla_decode_sharded``, holding exactly the rules' bytes and gathering
    no parameter block (its parity with the reference's serve step is
    ``tests/test_torch_decode_layouts.py``'s ``mla_r_s``)."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import meta_rank_mesh
    from repro_torch.models import mla
    from repro_torch.runtime import pspec

    mesh = {"data": 2, "model": 2}
    cfg = get_config("deepseek-v2-236b", reduced=True).replace(kv_lora_rank=512)
    with meta_rank_mesh(mesh, 0) as m, pspec.logical_axis_rules(m):
        specs = decode.cache_blocks(LM(cfg, device="meta"), 4, 256)
    for part in specs:
        assert specs[part]["c_kv"][3] == "model" and specs[part]["k_rope"][2] == "model", specs
    before = mla.mla_decode_sharded.calls
    _, coll, whole, held, _, _, _ = dryrun.analyze_rank_step(cfg, Shape("decode_32k", 256, 4, "decode"), mesh)
    assert mla.mla_decode_sharded.calls - before == cfg.num_layers
    assert held == dryrun.argument_bytes(mesh, whole, "decode")
    assert coll["parameter_gathers"] == []


def test_decode_step_with_serving_zero3_equals_the_reference(runs, monkeypatch):
    """``build_serve_step(..., mesh=...)`` with serving's ZeRO forced (the
    budget 0 on both sides): the router held with its d over 'data', so its
    logits are summed weight-stationary over 'data'; each rank's logits rows
    within 2e-4 of the reference's own serve step and of the port's
    unsharded decode step, its latent caches within 1e-5, its blocks the
    rules', and nothing gathered at use."""
    from _torch_sharded_ranks import COUNTERS

    ref, port, inp = runs
    key = "v2_serve_zero3"
    c, cfg = CASES[key], _cfg(key)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, ranks.tree_of(inp, f"{key}/params/")))
    cache = {}
    for k in (k[len(f"{key}/cache/"):] for k in inp if k.startswith(f"{key}/cache/")):
        part, leaf = k.split("/")
        cache.setdefault(part, {})[leaf] = torch.from_numpy(inp[f"{key}/cache/{k}"].copy())
    from repro_torch.models.attention import _decode_bspec

    rows = (_decode_bspec(MESH, c["B"]), None, None)
    rs = _ranks(port, c)
    for n, pos in enumerate(c["steps"]):
        own, cache = decode.decode_step(lm, torch.from_numpy(inp[f"{key}/tokens"][:, n:n + 1]), cache, pos)
        for r, coords in rs:
            got = r[f"{key}/logits{pos}"]
            for whole in (own.numpy(), ref[f"serve/{key}/logits{pos}"]):
                np.testing.assert_allclose(got, ranks.cut(whole, rows, MESH, coords), rtol=F32_TOL, atol=F32_TOL)
    monkeypatch.setattr(sharding, "_SERVE_ZERO3_BUDGET", 0)
    pspecs = sharding.param_specs(MESH, lm, serve=True)
    assert pspecs["moe_blocks.0.moe.router"] == ("data", None)
    for r, coords in rs:
        calls = dict(zip(COUNTERS, np.asarray(r[f"{key}/serve_calls"]).sum(axis=0).tolist()))
        assert calls["gathered"] == 0 and calls["moe"] > 0 and calls["mla"] > 0, calls
        psh = json.loads(str(r[f"{key}/param_specs"]))
        assert {k: tuple(tuple(x) if isinstance(x, list) else x for x in e) for k, e in psh.items()} == pspecs
        csh = json.loads(str(r[f"{key}/cache_specs"]))
        for k, t in _walk(cache):
            spec = tuple(tuple(e) if isinstance(e, list) else e for e in _at(csh, k))
            for whole in (t.numpy(), ref[f"serve/{key}/cache_after/{k}"]):
                np.testing.assert_allclose(r[f"{key}/cache_after/{k}"], ranks.cut(whole, spec, MESH, coords),
                                           rtol=1e-5, atol=1e-5, err_msg=f"cache {k} at {coords}")
