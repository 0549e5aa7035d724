"""The sharded training and prefill steps on ``torch.distributed`` against
the reference's own sharded steps, on the CPU.

The reference runs in a subprocess under eight forced host devices
(``tests/_jax_sharded_train_reference.py``: its ``build_train_step(lm,
mesh, tcfg)`` and ``build_prefill_step(lm, mesh)`` jitted with the
parameters, optimizer state and batch placed by its sharding rules); the
port runs on eight spawned gloo ranks on a mesh of the same shape
(``launch.mesh.run_ranks``, one intra-op thread a rank;
``tests/_torch_sharded_train_ranks.py``), the two at once. Both read the
same inputs: the reference's parameter tree of a model the port
initialises from a seed, carried to the ranks by ``params_from_reference``
and cut by the step itself, and batches drawn with NumPy from a seed whose
labels are masked unevenly by row. Cases: reduced gemma2-9b on 2 × 4
(adamw, 2 microbatches), on 2 × 2 × 2 with a pod axis (adamw8), reduced
nemotron-4-15b on 2 × 4 (squared-ReLU MLP, untied embeddings, remat), each
3 steps, and reduced gemma2-9b's prefill step on 2 × 4 (the hybrid, vlm
and encdec families: ``test_torch_sharded_families.py``).

Each step's loss and grad norm within 1e-5 relative of the reference's
and of the port's own unsharded step, the learning rate equal. Each
rank's parameter blocks after the steps against the same block of the
reference's global parameters and of the unsharded step's, in units of
the leaf's largest change over the steps: every element within 1e-2
(AdamW) or 1e-1 (adamw8), and at most 1e-3 of a block's elements beyond
1e-3 or 1e-2 (``_torch_sharded_train_ranks.assert_within_change``); the
adamw8 codes and scales.
The prefill's logits rows within 1e-4 of the largest logit. Also the
training CLI on 4 gloo ranks with a restart that continues bit for bit
(gemma2-9b, whisper-base and deepseek-v2-236b), and that the moe and ssm
families' steps and the compressed step across a pod axis build under the
mesh (``test_torch_sharded_moe.py``, ``test_torch_sharded_ssm.py``,
``test_torch_pod_compress.py``).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import mesh_shape_from_ranks, run_ranks
from repro_torch.models import LM, params_from_reference
from repro_torch.models.interop import opt_state_from_reference
from repro_torch.runtime import sharding
from repro_torch.runtime.train import build_prefill_step, build_train_step, init_opt_state

import _torch_sharded_train_ranks as ranks

MESH = {"data": 2, "model": 4}                 # the reference tests' mesh
POD = {"pod": 2, "data": 2, "model": 2}        # batch rows over (pod, data), parameters replicated over pods
F32 = dict(param_dtype="float32", compute_dtype="float32")
SHARDED_LAST = ["deepseek-v2-236b", "mamba2-780m"]   # the moe and ssm families, the last to run under a mesh
CASES = {
    # local window 8, so that it bites at 32 tokens
    "gemma2": dict(kind="train", arch="gemma2-9b", over=dict(F32, remat=False, local_window=8), mesh=MESH, B=8,
                   S=32, steps=3, tcfg=dict(ranks.TCFG, microbatches=2, optimizer="adamw"), seed=1),
    "gemma2_pod": dict(kind="train", arch="gemma2-9b", over=dict(F32, remat=False, local_window=8), mesh=POD, B=8,
                       S=32, steps=3, tcfg=dict(ranks.TCFG, microbatches=1, optimizer="adamw8"), seed=2),
    "nemotron": dict(kind="train", arch="nemotron-4-15b", over=F32, mesh=MESH, B=8, S=32, steps=3,
                     tcfg=dict(ranks.TCFG, microbatches=1, optimizer="adamw"), seed=3),
    "prefill": dict(kind="prefill", arch="gemma2-9b", over=dict(F32, local_window=8), mesh=MESH, B=8, S=32, seed=4),
    "refusals": dict(kind="refusals", archs=SHARDED_LAST, mesh=POD),
}
TRAIN = [k for k, c in CASES.items() if c["kind"] == "train"]
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
        if c["kind"] == "refusals":
            continue
        cfg = _cfg(key)
        inp |= {f"{key}/params/{k}": v for k, v in ranks.reference_tree(cfg, c["seed"]).items()}
        for s, b in enumerate(ranks.batches(cfg, c["B"], c["S"], c.get("steps", 1), c["seed"])):
            inp |= {f"{key}/{n}{s}": a for n, a in b.items()}
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, each mesh's ranks' results, the inputs): the
    reference subprocess and the ranks run at the same time."""
    inp = _inputs()
    ref, port = ranks.run_with_reference(tmp_path_factory.mktemp("sharded_train"), CASES, inp,
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
            m = step(opt, {n: inp[f"{key}/{n}{s}"] for n in ("tokens", "labels")})
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
    step's, in units of the leaf's largest change (``assert_within_change``)."""
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


@pytest.mark.parametrize("mesh", [MESH, POD, {"data": 4}, {"pod": 2, "model": 4}, {"model": 8}],
                         ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
def test_batch_axes_are_the_axes_batch_specs_splits_over(mesh):
    """``batch_axes`` names the axes ``batch_specs`` shards a batch over
    that divides them, pod-major."""
    n = int(np.prod([mesh.get(a, 1) for a in ("pod", "data")]))
    spec = sharding.batch_specs(mesh, {"x": torch.empty(4 * n, 3)})["x"][0]
    axes = () if spec is None else spec if isinstance(spec, tuple) else (spec,)
    assert sharding.batch_axes(mesh) == tuple(a for a in axes if mesh.get(a, 1) > 1)


def test_adamw8_codes_and_scales_equal_the_reference(runs):
    """The adamw8 case's moments: every rank's block of each leaf's codes and
    scales against the reference's (carried across by
    ``opt_state_from_reference``) and the unsharded step's. Scales within
    1e-2 relative, or 1e-4 of the leaf's largest scale: a scale is its
    block's largest |moment| / 127, and a code that took the next value at
    one step moves that moment by a code step (1/127 of the scale) at the
    next (measured: 1.7e-3 of a block's scale); codes equal but where a moment sits at a rounding
    boundary and takes the next code, at most 1 apart on at most 1% of a
    leaf's codes. The embedding's and the MLP's moments are whole along
    their last dimension (the one block of 128 or 256 does not divide over
    'data' or 'model') while the parameter is cut."""
    ref, port, inp = runs
    key, c, cfg = "gemma2_pod", CASES["gemma2_pod"], _cfg("gemma2_pod")
    want = opt_state_from_reference(cfg, ranks.tree_of(ref, f"{key}/opt/") | {"step": np.asarray(3)}, "adamw8")
    own = _unsharded(key, inp)[3]
    dropped = 0
    for r, coords in _ranks(port, c):
        specs = json.loads(str(r[f"{key}/specs"]))
        for mom in ("m", "v"):
            for name, spec in specs["opt"][mom].items():
                pspec = specs["params"][name]
                dropped += bool(pspec and pspec[-1] is not None and spec["scale"][-1] is None)
                for side, whole in (("reference", want[mom][name]), ("unsharded", own[mom][name])):
                    q = r[f"{key}/opt/{mom}/{name}/q"]
                    wq = ranks.cut(whole["q"].numpy(), spec["q"], c["mesh"], coords)
                    diff = np.abs(q.astype(np.int32) - wq.astype(np.int32))
                    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (side, mom, name, coords, diff.sum())
                    np.testing.assert_allclose(r[f"{key}/opt/{mom}/{name}/scale"],
                                               ranks.cut(whole["scale"].numpy(), spec["scale"], c["mesh"], coords),
                                               rtol=1e-2, atol=1e-4 * float(whole["scale"].abs().max()),
                                               err_msg=f"{side} {mom} {name} at {coords}")
    assert dropped > 0


@pytest.mark.parametrize("key", TRAIN)
def test_every_layer_runs_sharded(runs, key):
    """Each step runs every block's attention and MLP through the sharded
    functions, once a microbatch (twice with remat: the recompute)."""
    c = CASES[key]
    cfg = _cfg(key)
    per = cfg.num_layers * c["tcfg"]["microbatches"] * (2 if cfg.remat else 1)
    for r, _ in _ranks(runs[1], c):
        assert r[f"{key}/calls"].tolist() == [[per, per]] * c["steps"]


def test_prefill_step_equals_the_reference(runs):
    """Each rank's rows of the (B, 1, V) logits within 1e-4 of the largest
    logit of the reference's sharded prefill and of the port's unsharded
    one; gemma2 at m = 4 serves TP-only (``needs_zero3`` false)."""
    ref, port, inp = runs
    c, cfg = CASES["prefill"], _cfg("prefill")
    own = build_prefill_step(ranks.model(cfg, inp, "prefill"))({"tokens": inp["prefill/tokens0"]}).numpy()
    want = ref["prefill/logits"]
    rows = (sharding.batch_specs(MESH, {"x": torch.empty(c["B"])})["x"][0], None, None)
    for r, coords in _ranks(port, c):
        got = r["prefill/logits"]
        for whole in (want, own):
            np.testing.assert_allclose(got, ranks.cut(whole, rows, MESH, coords), rtol=0,
                                       atol=LOGITS_TOL * np.abs(whole).max())
        assert int(r["prefill/calls"]) == cfg.num_layers
        assert all("data" not in json.dumps(s) for s in json.loads(str(r["prefill/specs"])).values())


def test_refusals_under_a_placed_mesh(runs):
    """Nothing refuses any more: the moe and ssm families' train and prefill
    steps and the compressed step across a pod axis build under the mesh
    (the compressed step's values: ``test_torch_pod_compress.py``)."""
    for r, _ in _ranks(runs[1], CASES["refusals"]):
        msgs = [str(m) for m in r["refusals/messages"]]
        assert len(msgs) == 2 * len(SHARDED_LAST) + 1
        assert {get_config(a).family for a in SHARDED_LAST} == {"moe", "ssm"}
        assert msgs == [""] * (2 * len(SHARDED_LAST) + 1), msgs


def test_a_shapes_only_mesh_is_refused():
    lm = LM(get_config("gemma2-9b", reduced=True), device="cpu")
    for build in (lambda: build_train_step(lm, mesh=MESH), lambda: build_prefill_step(lm, mesh=MESH)):
        with pytest.raises(ValueError, match="placed over a process group"):
            build()


@pytest.mark.parametrize("world,shape", [(1, (1, 1)), (2, (1, 2)), (4, (1, 4)), (6, (3, 2)), (8, (1, 8)),
                                         (12, (3, 4)), (16, (1, 16)), (32, (2, 16)), (48, (3, 16))])
def test_mesh_from_ranks_follows_the_reference_cli(world, shape):
    """'model' is the first of 16, 8, 4, 2, 1 that divides the world
    (``repro.launch.train.make_mesh_from_devices``), 'data' the rest."""
    assert mesh_shape_from_ranks(world) == dict(zip(("data", "model"), shape))


@pytest.mark.parametrize("arch", ["gemma2-9b", "whisper-base", "deepseek-v2-236b"])
def test_cli_trains_under_four_ranks_and_resumes(tmp_path, arch):
    """launch/train.py on 4 gloo ranks (the reference's rule: 'model' 4):
    6 steps with a checkpoint every 2; the run cut after its step-5 save
    (the final one deleted) resumes there and ends on every rank's blocks
    bit for bit where the unbroken run ends. The checkpoint is the whole
    tensors in the one-device format: the one-device CLI resumes from it.
    whisper-base's zero audio embeddings go through ``shard_batch`` with
    the tokens; deepseek-v2-236b's experts (over 'model', d over 'data')
    and its aux loss through the gather dispatch of the sharded batch."""
    import shutil

    from repro_torch.launch import train as train_cli

    args = ["--arch", arch, "--reduced", "--steps", "6", "--global-batch", "4", "--seq", "32",
            "--ckpt-every", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path / "a")]
    shape = {"data": 1, "model": 4}
    full = run_ranks(ranks.cli, shape, backend="gloo", device_type="cpu", args=(args,), timeout=300)
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["step_00000005", "step_00000006"]
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    shutil.rmtree(tmp_path / "a" / "step_00000006")
    resumed = run_ranks(ranks.cli, shape, backend="gloo", device_type="cpu", args=(args,), timeout=300)
    for a, b in zip(full, resumed):
        assert json.loads(str(a["mesh"])) == shape and int(a["step"]) == int(b["step"]) == 6
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the checkpoint holds the whole model: the one-device CLI restores it
    shutil.rmtree(tmp_path / "b" / "step_00000006")
    lm, opt = train_cli.main(args[:-1] + [str(tmp_path / "b")])
    assert int(opt["step"]) == 6
    assert tuple(lm.embed.shape) == (lm.cfg.padded_vocab, lm.cfg.d_model)
