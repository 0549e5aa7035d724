"""The ssm family's sharded training, prefill and decode steps on
``torch.distributed`` against the reference's own sharded steps, on the
CPU.

As ``test_torch_sharded_families.py`` does for the hybrid, vlm and encdec
families: the reference's ``build_train_step(lm, mesh, tcfg)``,
``build_prefill_step(lm, mesh)`` and ``build_serve_step(lm, mesh, B,
max_len)`` in a subprocess under eight forced host devices
(``tests/_jax_sharded_train_reference.py``), the port on eight spawned
gloo ranks on a mesh of the same shape
(``tests/_torch_sharded_train_ranks.py``), the two at once, on the same
inputs. Cases, reduced mamba2-780m in float32 (16 heads of 16, d_inner
256, in_proj's 560 columns z | x | B | C | dt, chunk 32), B 8 × S 64
(two chunks), 3 steps:

* on 2 × 4 with AdamW and 2 microbatches: 4 heads a rank, so that the
  gated norm's sum over 'model' counts (a norm over a rank's columns alone
  is wrong by a per-row factor) and the contiguous cut of in_proj (140
  columns a rank) crosses its sections;
* on 2 × 2 × 2 with a pod axis and adamw8 (8 heads a rank);
* the prefill on 2 × 4;
* the decode through ``build_serve_step`` from random conv and state
  caches, 3 steps, each cache cut as the rules cut it: on 2 × 4 at B 8
  (conv by its channels, the state by its heads), the same with 32 states
  (the state by its N-block: y's partial sums summed over 'model'), and on
  1 × 4 at B 32 (the state by its rows, the batch its longest dimension);
* ``mamba_sharded`` with 2 heads (``ssm_head_dim`` 128), which do not
  divide 'model' 4: the block runs whole.

Held to the dense family's limits: each step's loss and grad norm within
1e-5 relative of the reference's and of the port's unsharded step, the
learning rate equal; every rank's parameter blocks by
``assert_within_change``; the adamw8 codes and scales; the prefill's
logits rows within 1e-4 of the largest logit; the decode's within
``F32_TOL`` 2e-4. Every layer runs through ``mamba_sharded``.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import LM, decode, params_from_reference, ssm
from repro_torch.models.interop import opt_state_from_reference
from repro_torch.runtime import sharding
from repro_torch.runtime.train import build_prefill_step, build_train_step, init_opt_state

import _torch_sharded_train_ranks as ranks
from _torch_sharded_ranks import _walk

MESH = {"data": 2, "model": 4}                 # the reference tests' mesh
POD = {"pod": 2, "data": 2, "model": 2}        # batch rows over (pod, data), parameters replicated over pods
ROW = {"data": 1, "model": 4}                  # rows over 'model' where the batch is a cache's longest dimension
MESHES = {"2x4": MESH, "pod": POD, "1x4": ROW}
F32 = dict(param_dtype="float32", compute_dtype="float32")
MAMBA = dict(F32, remat=False)
CASES = {
    "mamba": dict(kind="train", arch="mamba2-780m", over=MAMBA, mesh=MESH, B=8, S=64, steps=3,
                  tcfg=dict(ranks.TCFG, microbatches=2, optimizer="adamw"), seed=41),
    "mamba_pod": dict(kind="train", arch="mamba2-780m", over=dict(F32, remat=True), mesh=POD, B=8, S=64, steps=3,
                      tcfg=dict(ranks.TCFG, microbatches=1, optimizer="adamw8"), seed=42),
    "mamba_prefill": dict(kind="prefill", arch="mamba2-780m", over=MAMBA, mesh=MESH, B=8, S=64, seed=43),
    "mamba_serve": dict(kind="serve", arch="mamba2-780m", over=F32, mesh=MESH, B=8, max_len=1024, steps=[0, 1, 2],
                        seed=44),
    "mamba_serve_n": dict(kind="serve", arch="mamba2-780m", over=dict(F32, ssm_state=32), mesh=MESH, B=8,
                          max_len=256, steps=[0, 1, 2], seed=46),
    "mamba_serve_rows": dict(kind="serve", arch="mamba2-780m", over=F32, mesh=ROW, B=32, max_len=256,
                             steps=[0, 1, 2], seed=47),
    # 2 heads of 128 do not divide 'model' (4): the block runs whole
    "mamba_whole": dict(kind="mamba_whole", arch="mamba2-780m", over=dict(F32, ssm_head_dim=128), mesh=MESH, B=8,
                        S=64, seed=45),
}
TRAIN = [k for k, c in CASES.items() if c["kind"] == "train"]
SERVE = [k for k, c in CASES.items() if c["kind"] == "serve"]
STATE_CUT = {"mamba_serve": 2, "mamba_serve_n": 4, "mamba_serve_rows": 1}   # the state's dimension over 'model'
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
        rng = np.random.default_rng(c["seed"])
        if c["kind"] == "mamba_whole":
            p = ssm.init_mamba(cfg, "cpu")
            ssm.init_mamba_(p, cfg, torch.Generator().manual_seed(c["seed"]))
            inp |= {f"{key}/mix/{k}": t.detach().numpy().copy() for k, t in p.items()}
            for k in ("norm", "conv_b", "dt_bias"):
                inp[f"{key}/mix/{k}"] = (rng.standard_normal(p[k].shape) * 0.1).astype(np.float32)
            inp[f"{key}/x"] = rng.standard_normal((c["B"], c["S"], cfg.d_model)).astype(np.float32)
            continue
        inp |= {f"{key}/params/{k}": v for k, v in ranks.reference_tree(cfg, c["seed"]).items()}
        if c["kind"] == "serve":
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
    ref, port = ranks.run_with_reference(tmp_path_factory.mktemp("sharded_ssm"), CASES, inp, MESHES)
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
    every leaf moved, A_log, D, dt_bias and the gated norm's scale too."""
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


def test_in_proj_is_cut_across_its_sections(runs):
    """in_proj's 560 columns are cut 140 a rank over 'model' 4: rank 1's
    block holds the end of z (256 wide) and the start of x."""
    r, coords = next((r, c) for r, c in _ranks(runs[1], CASES["mamba"]) if c["model"] == 1)
    specs = json.loads(str(r["mamba/specs"]))["params"]
    assert specs["blocks.0.mix.in_proj"] == ["data", "model"]
    assert r["mamba/params/blocks.0.mix.in_proj"].shape == (128 // 2, 560 // 4)


def test_adamw8_codes_and_scales_equal_the_reference(runs):
    """The pod case's moments (adamw8 on 2 × 2 × 2): every rank's block of
    each leaf's codes and scales against the reference's and the unsharded
    step's, within the limits of the dense family's test of the same name
    but the codes' gap, ``CODE_GAP``: at most 1% of a leaf's codes differ."""
    ref, port, inp = runs
    key, c, cfg = "mamba_pod", CASES["mamba_pod"], _cfg("mamba_pod")
    want = opt_state_from_reference(cfg, ranks.tree_of(ref, f"{key}/opt/") | {"step": np.asarray(3)}, "adamw8")
    own = _unsharded(key, inp)[3]
    for r, coords in _ranks(port, c):
        specs = json.loads(str(r[f"{key}/specs"]))
        for mom in ("m", "v"):
            for name, spec in specs["opt"][mom].items():
                for side, whole in (("reference", want[mom][name]), ("unsharded", own[mom][name])):
                    q = r[f"{key}/opt/{mom}/{name}/q"]
                    wq = ranks.cut(whole["q"].numpy(), spec["q"], c["mesh"], coords)
                    diff = np.abs(q.astype(np.int32) - wq.astype(np.int32))
                    assert diff.max() <= CODE_GAP and (diff > 0).mean() <= 0.01, (side, mom, name, coords, diff.sum())
                    np.testing.assert_allclose(r[f"{key}/opt/{mom}/{name}/scale"],
                                               ranks.cut(whole["scale"].numpy(), spec["scale"], c["mesh"], coords),
                                               rtol=1e-2, atol=1e-4 * float(whole["scale"].abs().max()),
                                               err_msg=f"{side} {mom} {name} at {coords}")


@pytest.mark.parametrize("key", TRAIN)
def test_every_layer_runs_sharded(runs, key):
    """Each step runs every Mamba-2 block through ``mamba_sharded``, once a
    microbatch (twice with remat: the recompute), and nothing through the
    other families' sharded layers."""
    c, cfg = CASES[key], _cfg(key)
    n = cfg.num_layers * c["tcfg"]["microbatches"] * (2 if cfg.remat else 1)
    for r, _ in _ranks(runs[1], c):
        assert r[f"{key}/layer_calls"].tolist() == [[0, 0, 0, 0, n, 0, 0]] * c["steps"], ranks.LAYERS


def test_prefill_step_equals_the_reference(runs):
    """Each rank's rows of the (B, 1, V) logits within 1e-4 of the largest
    logit of the reference's sharded prefill and of the port's unsharded
    one, every block run sharded once."""
    ref, port, inp = runs
    key = "mamba_prefill"
    c, cfg = CASES[key], _cfg(key)
    batch = ranks.batch_of(inp, key, 0)
    batch.pop("labels")
    own = build_prefill_step(ranks.model(cfg, inp, key))(batch).numpy()
    want = ref[f"{key}/logits"]
    rows = (sharding.batch_specs(MESH, {"x": torch.empty(c["B"])})["x"][0], None, None)
    for r, coords in _ranks(port, c):
        got = r[f"{key}/logits"]
        for whole in (want, own):
            np.testing.assert_allclose(got, ranks.cut(whole, rows, MESH, coords), rtol=0,
                                       atol=LOGITS_TOL * np.abs(whole).max())
        assert r[f"{key}/layer_calls"].tolist() == [0, 0, 0, 0, cfg.num_layers, 0, 0]


def test_decode_step_under_the_mesh_equals_the_reference(runs):
    """The decode on 2 × 4 at B 8, the state cut by its heads
    (``_serve_against_the_reference``)."""
    _serve_against_the_reference(runs, "mamba_serve")


@pytest.mark.parametrize("key", [k for k in SERVE if k != "mamba_serve"])
def test_decode_step_reads_the_state_where_the_rules_cut_it(runs, key):
    """The decode with the state cut by its N-block (2 × 4, 32 states) and
    by its rows (1 × 4, B 32) (``_serve_against_the_reference``)."""
    _serve_against_the_reference(runs, key)


def _serve_against_the_reference(runs, key):
    """``build_serve_step(..., mesh=...)``: each rank's logits rows against
    the reference's own serve step under the mesh and the port's unsharded
    decode step within 2e-4, and its blocks of the conv and state caches
    after the last step within 1e-5. Every rank holds the rules' blocks:
    the parameters as ``param_specs(..., serve=True)`` cuts them (in_proj's
    columns, conv_w's channels and out_proj's rows over 'model', the tied
    table's vocab), the caches as ``cache_specs`` does (conv by its
    channels; the state by its heads, its N-block or its rows), and every
    layer runs through ``mamba_decode_sharded``, none gathered at use."""
    from repro_torch.models.attention import _decode_bspec
    from repro_torch.runtime.serve import abstract_cache

    from _torch_sharded_ranks import COUNTERS

    ref, port, inp = runs
    c, cfg = CASES[key], _cfg(key)
    mesh = c["mesh"]
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, ranks.tree_of(inp, f"{key}/params/")))
    cache = {k: torch.from_numpy(inp[f"{key}/cache/{k}"].copy()) for k in ("conv", "state")}
    rows = (_decode_bspec(mesh, c["B"]), None, None)
    rs = _ranks(port, c)
    for n, pos in enumerate(c["steps"]):
        own, cache = decode.decode_step(lm, torch.from_numpy(inp[f"{key}/tokens"][:, n:n + 1]), cache, pos)
        for r, coords in rs:
            got = r[f"{key}/logits{pos}"]
            for whole in (own.numpy(), ref[f"serve/{key}/logits{pos}"]):
                np.testing.assert_allclose(got, ranks.cut(whole, rows, mesh, coords), rtol=F32_TOL, atol=F32_TOL)
    rules = sharding.cache_specs(mesh, abstract_cache(lm, c["B"], c["max_len"]), c["B"])
    assert rules["state"][STATE_CUT[key]] == "model" and rules["conv"][3] == "model", rules
    pspecs = sharding.param_specs(mesh, lm, serve=True)
    assert pspecs["embed"] == ("model", None) and pspecs["blocks.0.mix.in_proj"] == (None, "model")
    for r, coords in rs:
        calls = dict(zip(COUNTERS, np.asarray(r[f"{key}/serve_calls"]).sum(axis=0).tolist()))
        assert calls == {k: cfg.num_layers * len(c["steps"]) if k == "mamba" else 0 for k in COUNTERS}, calls
        csh = json.loads(str(r[f"{key}/cache_specs"]))
        psh = json.loads(str(r[f"{key}/param_specs"]))
        assert {k: tuple(tuple(x) if isinstance(x, list) else x for x in e) for k, e in psh.items()} == pspecs
        for k in ("conv", "state"):
            spec = tuple(tuple(e) if isinstance(e, list) else e for e in csh[k])
            assert spec == rules[k], (k, spec)
            for whole in (cache[k].numpy(), ref[f"serve/{key}/cache_after/{k}"]):
                np.testing.assert_allclose(r[f"{key}/cache_after/{k}"], ranks.cut(whole, spec, mesh, coords),
                                           rtol=1e-5, atol=1e-5, err_msg=f"cache {k} at {coords}")


def test_mamba_sharded_runs_a_head_count_that_does_not_divide_whole(runs):
    """At 2 heads over 'model' 4 each rank runs the whole block on its
    rows on the gathered weights, equal to ``mamba_forward`` of the whole
    parameters."""
    c = CASES["mamba_whole"]
    for r, coords in _ranks(runs[1], c):
        specs = json.loads(str(r["mamba_whole/specs"]))
        assert specs["out_proj"] == ["model", "data"]
        assert int(r["mamba_whole/calls"]) == 1
        np.testing.assert_allclose(r["mamba_whole/got"], r["mamba_whole/want"], rtol=1e-6, atol=1e-6,
                                   err_msg=str(coords))
