"""The port's side of ``tests/test_torch_sharded_train.py``: what each rank
of an 8-rank gloo mesh runs (spawned by ``launch.mesh.run_ranks``, so it
lives in a module the ranks import; it imports no JAX).

``run(mesh, workdir)`` reads the cases (``cases.json``) and the inputs
(``inputs.npz``) the test wrote, and for each case of this mesh's shape
builds the model from the reference's parameter tree
(``params_from_reference``), runs the sharded step on this rank's blocks
and rows, and returns NumPy arrays: each step's metrics, the rank's
parameter blocks (and adamw8 codes and scales) after the last step and
on the first rank the whole parameters gathered from them, the
prefill's logits rows, and the sharded layers each step ran. ``cli`` runs
the training CLI on a rank and returns its parameter blocks, and
``card_step`` a rank of the card test's sharded step
(``tests/test_torch_cuda.py``). The helpers ``reference_tree``,
``batches``, ``TCFG`` and ``assert_within_change`` are shared with the
tests.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import LM, attention, params_from_reference
from repro_torch.models.interop import STACKED
from repro_torch.runtime.sharding import gather_blocks
from repro_torch.runtime.train import TrainConfig, build_prefill_step, build_train_step, init_opt_state, shard_batch

# 1e-3 at its peak, reached after one warmup step (step 0's learning rate is 0)
TCFG = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)

# A parameter against another step's (the reference's, the port's one
# process), in units of its leaf's largest change over the 3 steps, in two parts: the worst element within
# PARAM_TOL, and at most PARAM_SHARE of each block's elements beyond
# PARAM_TIGHT. AdamW's m/√v turns a gradient's last-place difference
# (another order of summation: the mesh's reductions) into an O(1)
# difference of the update where |g| is near that difference, on a few
# elements: measured, the worst 2.2e-3 of the change and at most 1 element
# of a block of 8,192 beyond 1e-3 (nemotron); adamw8 adds its codes (a
# moment at a rounding boundary takes the next code): the worst 3.9e-2,
# at most 2 elements of 8,192 beyond 1e-2. A fault that moves whole blocks
# moves most of their elements: weight decay skipped on the cut blocks
# puts 10-93% of every cut matrix's elements beyond those limits.
PARAM_TOL = {"adamw": 1e-2, "adamw8": 1e-1}
PARAM_TIGHT = {"adamw": 1e-3, "adamw8": 1e-2}
PARAM_SHARE = 1e-3


def assert_within_change(got: np.ndarray, want: np.ndarray, change: float, optimizer: str, what: str) -> None:
    """A parameter block against another in units of its leaf's largest
    change: every element within PARAM_TOL, at most PARAM_SHARE of them
    beyond PARAM_TIGHT."""
    d = np.abs(got - want) / change
    worst, share = float(d.max()), float((d > PARAM_TIGHT[optimizer]).mean())
    assert worst <= PARAM_TOL[optimizer] and share <= PARAM_SHARE, (
        f"{what}: {worst!r} of the change (limit {PARAM_TOL[optimizer]}), {share!r} of the elements beyond "
        f"{PARAM_TIGHT[optimizer]} (limit {PARAM_SHARE})")


def config(case: dict):
    return get_config(case["arch"], reduced=True).replace(**case["over"])


def tcfg_of(case: dict) -> TrainConfig:
    tc = case["tcfg"]
    return TrainConfig(peak_lr=tc["peak_lr"], warmup_steps=tc["warmup_steps"], total_steps=tc["total_steps"],
                       microbatches=tc["microbatches"], optimizer=tc["optimizer"])


def reference_tree(cfg, seed: int) -> dict:
    """The reference's parameter tree (flat '/' keys, NumPy leaves, a
    family's layers stacked) of a model the port initialises from ``seed``;
    its zero-initialised norm scales drawn N(0, 0.1) so that they count."""
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    groups: dict = {}
    for name, p in lm.named_parameters():
        a = p.detach().float().numpy().copy()
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


def batches(cfg, B: int, S: int, steps: int, seed: int) -> list[dict]:
    """``steps`` global batches: tokens, and labels masked unevenly by row
    (row r loses about r/(2B) of its labels, to −1 or past the vocabulary),
    so that a microbatch's count of unmasked labels depends on its rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        drop = rng.random((B, S)) < (np.arange(B)[:, None] / (2.0 * B))
        labels[drop] = np.where(rng.random(int(drop.sum())) < 0.5, -1, cfg.vocab_size + 3)
        out.append({"tokens": toks, "labels": labels})
    return out


def tree_of(inp, prefix: str) -> dict:
    """A flat '/'-keyed part of ``inp`` as a nested dict."""
    tree: dict = {}
    for k in inp:
        if not k.startswith(prefix):
            continue
        *path, last = k[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = inp[k]
    return tree


def model(cfg, inp, key: str) -> LM:
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, tree_of(inp, f"{key}/params/")))
    return lm


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy().copy()


def _batch(inp, key: str, s: int) -> dict:
    return {n: inp[f"{key}/{n}{s}"] for n in ("tokens", "labels")}


def _train(mesh, key, case, inp, out):
    cfg, tcfg = config(case), tcfg_of(case)
    lm = model(cfg, inp, key)
    step, (psh, osh) = build_train_step(lm, tcfg, mesh=mesh)
    opt = init_opt_state(lm, tcfg.optimizer)
    metrics, calls = [], []
    for s in range(case["steps"]):
        before = attention.attention_sharded.calls, attention.mlp_sharded.calls
        m = step(opt, shard_batch(_batch(inp, key, s), mesh))
        calls.append((attention.attention_sharded.calls - before[0], attention.mlp_sharded.calls - before[1]))
        metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
    out[f"{key}/metrics"] = np.asarray(metrics, np.float64)
    out[f"{key}/calls"] = np.asarray(calls)
    for name, p in lm.named_parameters():
        out[f"{key}/params/{name}"] = _np(p)
    whole = gather_blocks(dict(lm.named_parameters()), psh, mesh, keep=not any(mesh.coords.values()))
    out[f"{key}/kept"] = np.asarray(whole is not None)
    for name, t in (whole or {}).items():
        out[f"{key}/whole/{name}"] = _np(t)
    if tcfg.optimizer == "adamw8":
        for mom in ("m", "v"):
            for name, st in opt[mom].items():
                for part in ("q", "scale"):
                    out[f"{key}/opt/{mom}/{name}/{part}"] = _np(st[part])
    out[f"{key}/specs"] = np.asarray(json.dumps({"params": psh, "opt": {m: osh[m] for m in ("m", "v")}}))


def _prefill(mesh, key, case, inp, out):
    cfg = config(case)
    step, psh = build_prefill_step(model(cfg, inp, key), mesh=mesh)
    before = attention.attention_sharded.calls
    out[f"{key}/logits"] = _np(step(shard_batch(_batch(inp, key, 0), mesh)))
    out[f"{key}/calls"] = np.asarray(attention.attention_sharded.calls - before)
    out[f"{key}/specs"] = np.asarray(json.dumps(psh))


def _refusals(mesh, key, case, inp, out):
    """What the sharded steps refuse, as messages: each non-dense family's
    train and prefill steps, and compress_pod_grads across a pod axis."""
    msgs = []
    for arch in case["archs"]:
        for build in (lambda lm: build_train_step(lm, TrainConfig(), mesh=mesh),
                      lambda lm: build_prefill_step(lm, mesh=mesh)):
            msgs.append(_message(lambda: build(LM(get_config(arch, reduced=True), device="cpu"))))
    if mesh.get("pod", 1) > 1:
        cfg = get_config("gemma2-9b", reduced=True)
        msgs.append(_message(lambda: build_train_step(LM(cfg, device="cpu"), TrainConfig(compress_pod_grads=True),
                                                      mesh=mesh)))
    out[f"{key}/messages"] = np.asarray(msgs)


def _message(fn) -> str:
    try:
        fn()
        return ""
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"


RUN = {"train": _train, "prefill": _prefill, "refusals": _refusals}


def run(mesh, workdir: str) -> dict:
    workdir = Path(workdir)
    cases = json.loads((workdir / "cases.json").read_text())
    inp = np.load(workdir / "inputs.npz")
    out = {"coords": np.array([mesh.coords[a] for a in mesh])}
    for key, case in cases.items():
        if case["mesh"] == dict(mesh):
            RUN[case["kind"]](mesh, key, case, inp, out)
    return out


def cli(mesh, argv: list) -> dict:
    """The training CLI on this rank (the process group is up): its
    parameter blocks after the run, and its mesh."""
    from repro_torch.launch import train

    lm, opt = train.main(argv)
    out = {name: _np(p) for name, p in lm.named_parameters()}
    out["step"] = np.asarray(int(opt["step"]))
    out["mesh"] = np.asarray(json.dumps(dict(lm.placement.mesh)))
    return out


# reduced gemma2 for the card test: float32, remat, the window cut to 8
CARD_CFG = dict(num_layers=4, local_window=8, remat=True, param_dtype="float32", compute_dtype="float32")


def card_step(mesh) -> dict:
    """3 train steps of reduced gemma2 built on the card from a seed, on one
    process (``mesh`` None: the whole parameters before and after) or on
    this rank of ``mesh`` (its blocks): metrics, parameters, the flash
    forward and backward launches."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config("gemma2-9b", reduced=True).replace(**CARD_CFG)
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    out = {"before": {k: _np(p) for k, p in lm.named_parameters()}} if mesh is None else {}
    tcfg = TrainConfig(**TCFG)
    if mesh is None:
        step = build_train_step(lm, tcfg)
    else:
        step, (psh, _) = build_train_step(lm, tcfg, mesh=mesh)
        out |= {"coords": np.array([mesh.coords[a] for a in mesh]), "specs": np.asarray(json.dumps(psh))}
    opt = init_opt_state(lm)
    before = fa_ops.flash_attention.launches, fa_ops.flash_attention_bwd.launches
    metrics = []
    for b in batches(cfg, 4, 48, 3, seed=7):
        m = step(opt, b if mesh is None else shard_batch(b, mesh))
        metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
    torch.cuda.synchronize()
    out |= {"metrics": np.asarray(metrics), "params": {k: _np(p) for k, p in lm.named_parameters()},
            "launches": np.asarray([fa_ops.flash_attention.launches - before[0],
                                    fa_ops.flash_attention_bwd.launches - before[1]])}
    return out
