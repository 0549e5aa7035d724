"""The port's side of ``tests/test_torch_pod_compress.py``: what each of 8
gloo ranks on a 2 × 2 × 2 mesh runs (spawned by
``launch.mesh.run_ranks``, so it lives in a module the ranks import; it
imports no JAX).

``run(mesh, workdir)`` reads the cases (``cases.json``) and inputs
(``inputs.npz``) the test wrote. The ``sync`` case feeds each rank its
blocks of its pod's whole gradients (float32) to the int8 pod sum
(``runtime.train._int8_pod_sum``) and returns the blocks after it. Each
training case builds the model from the reference's parameter tree, runs
``build_train_step`` with ``compress_pod_grads`` (and, where the case
asks, without it on a second copy) for the case's steps on the rank's
rows, and returns each step's metrics, the rank's parameter blocks after
the last step and their specs.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.models import moe
from repro_torch.runtime import train
from repro_torch.runtime.sharding import local_block
from repro_torch.runtime.train import TrainConfig, build_train_step, init_opt_state, shard_batch

import _torch_sharded_train_ranks as ranks


def spec_of(spec) -> tuple:
    """A spec as JSON gives it back (lists for tuples) as a tuple."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def _sync(mesh, case, inp, out):
    specs = {n: spec_of(s) for n, s in case["specs"].items()}
    pod = mesh.coords["pod"]
    whole = {n: torch.from_numpy(np.ascontiguousarray(inp[f"sync/pod{pod}/{n}"])) for n in specs}
    grads = {n: local_block(t, specs[n], mesh).clone() for n, t in whole.items()}
    train._int8_pod_sum(grads, train._layout(mesh, specs, whole, None, "adamw"), mesh)
    for n, g in grads.items():
        out[f"sync/{n}"] = g.numpy().copy()


def _train(mesh, key, case, inp, out):
    cfg = ranks.config(case)
    tc = case["tcfg"]
    for compress in case["compress"]:
        tag = f"{key}/{'compressed' if compress else 'plain'}"
        lm = ranks.model(cfg, inp, key)
        tcfg = TrainConfig(peak_lr=tc["peak_lr"], warmup_steps=tc["warmup_steps"], total_steps=tc["total_steps"],
                           microbatches=tc["microbatches"], optimizer=tc["optimizer"], compress_pod_grads=compress)
        step, (psh, _) = build_train_step(lm, tcfg, mesh=mesh)
        opt = init_opt_state(lm, tcfg.optimizer)
        metrics = []
        for s in range(case["steps"]):
            m = step(opt, shard_batch(ranks.batch_of(inp, key, s), mesh))
            metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
        out[f"{tag}/metrics"] = np.asarray(metrics, np.float64)
        for name, p in lm.named_parameters():
            out[f"{tag}/params/{name}"] = p.detach().float().numpy().copy()
        out[f"{tag}/specs"] = np.asarray(json.dumps(psh))


def run(mesh, workdir: str) -> dict:
    workdir = Path(workdir)
    cases = json.loads((workdir / "cases.json").read_text())
    inp = np.load(workdir / "inputs.npz")
    out = {"coords": np.array([mesh.coords[a] for a in mesh])}
    for key, case in cases.items():
        moe.set_moe_impl("gather")
        if case["kind"] == "sync":
            _sync(mesh, case, inp, out)
        else:
            _train(mesh, key, case, inp, out)
    return out
