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
each family's prefill step on 2 × 4; and ``rglru_sharded`` at a width that
does not divide 'model'.

Held to the dense family's limits: each step's loss and grad norm within
1e-5 relative of the reference's and of the port's unsharded step, the
learning rate equal; every rank's parameter blocks by
``assert_within_change``; the adamw8 codes and scales; the prefill's
logits rows within 1e-4 of the largest logit.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import params_from_reference, rglru
from repro_torch.models.interop import opt_state_from_reference
from repro_torch.runtime import sharding
from repro_torch.runtime.train import build_prefill_step, build_train_step, init_opt_state

import _torch_sharded_train_ranks as ranks

MESH = {"data": 2, "model": 4}                 # the reference tests' mesh
POD = {"pod": 2, "data": 2, "model": 2}        # batch rows over (pod, data), parameters replicated over pods
F32 = dict(param_dtype="float32", compute_dtype="float32")
HYBRID = dict(F32, remat=False, local_window=8)                             # the window bites at 32 tokens
VLM = dict(F32, remat=False, num_layers=8, cross_attn_every=4, num_kv_heads=2)
WHISPER = dict(F32, remat=True)
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
}
TRAIN = [k for k, c in CASES.items() if c["kind"] == "train"]
PREFILL = [k for k, c in CASES.items() if c["kind"] == "prefill"]
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
        for s, b in enumerate(ranks.batches(cfg, c["B"], c["S"], c.get("steps", 1), c["seed"])):
            inp |= {f"{key}/{n}{s}": a for n, a in b.items()}
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, each mesh's ranks' results, the inputs): the
    reference subprocess and the ranks run at the same time."""
    inp = _inputs()
    ref, port = ranks.run_with_reference(tmp_path_factory.mktemp("sharded_families"), CASES, inp,
                                         {"2x4": MESH, "pod": POD})
    return ref, port, inp


def _ranks(port, case):
    """Each rank's results of the case's mesh, with its coordinates."""
    mesh = case["mesh"]
    return [(r, dict(zip(mesh, (int(c) for c in r["coords"])))) for r in port["2x4" if mesh == MESH else "pod"]]


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
