"""The reference's side of ``tests/test_torch_sharded_train.py``, run as a
script under eight forced host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/_jax_sharded_train_reference.py DIR

Reads ``DIR/cases.json`` and ``DIR/inputs.npz`` (written by the test) and
writes ``DIR/reference.npz``. For a training case: the reference's own
``build_train_step(lm, mesh, tcfg)`` jitted on a mesh of the case's shape,
the parameters placed by ``param_specs``, the optimizer state by
``opt_specs`` or ``opt8_specs`` and the batch (with the vlm's image or
encdec's audio embeddings) by ``batch_specs``, as the
reference CLI places them (``repro.launch.train``); each step's loss, grad
norm and learning rate, and the global parameters and (for adamw8) the
moments' codes and scales after the last step. For a prefill case:
``build_prefill_step(lm, mesh)``'s logits, the parameters placed by the
step's own shardings. A case's ``moe_impl`` is set by ``set_moe_impl``
before its step is traced; a case with ``drops`` also counts the (token,
choice) pairs the one-device gather dispatch drops in the loss of its
first batch. A ``serve`` case runs ``_jax_sharded_reference.serve``: the
reference's ``build_serve_step`` under the mesh. A case's
``serve_zero3_budget`` stands in for ``runtime.sharding``'s serving
budget while it runs (0: serving's ZeRO forced), and the embedding's
serving spec under it is written too.
"""
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import LM, moe  # noqa: E402
from repro.optim import AdamWConfig, adamw_init  # noqa: E402
from repro.optim.adamw8 import adamw8_init  # noqa: E402
from repro.runtime import sharding as shlib  # noqa: E402
from repro.runtime.pspec import logical_axis_rules  # noqa: E402
from repro.runtime.train import TrainConfig, build_prefill_step, build_train_step  # noqa: E402


BATCH_KEYS = ("tokens", "labels", "image_embeds", "audio_embeds")


def config(case):
    return get_config(case["arch"], reduced=True).replace(**case["over"])


def tree(inp, prefix):
    out = {}
    for k in inp:
        if k.startswith(prefix):
            *path, last = k[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[last] = jnp.asarray(inp[k])
    return out


def flat(t, prefix, out):
    for k, v in t.items():
        if isinstance(v, dict):
            flat(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)


def make_mesh(shape):
    return jax.make_mesh(tuple(shape.values()), tuple(shape), axis_types=(jax.sharding.AxisType.Auto,) * len(shape))


def batch_of(inp, key, s, mesh):
    """Step ``s``'s batch of case ``key``: tokens and labels, and the image
    or audio embeddings where the case has them, placed by ``batch_specs``."""
    b = {n: jnp.asarray(inp[f"{key}/{n}{s}"]) for n in BATCH_KEYS if f"{key}/{n}{s}" in inp}
    return jax.device_put(b, shlib.named(mesh, shlib.batch_specs(mesh, b)))


def train(key, case, inp, out):
    cfg = config(case)
    lm = LM(cfg)
    mesh = make_mesh(case["mesh"])
    tc = case["tcfg"]
    tcfg = TrainConfig(peak_lr=tc["peak_lr"], warmup_steps=tc["warmup_steps"], total_steps=tc["total_steps"],
                       microbatches=tc["microbatches"], optimizer=tc["optimizer"], adamw=AdamWConfig())
    with mesh, logical_axis_rules(mesh):
        step_fn, _, _ = build_train_step(lm, mesh, tcfg)
        params = tree(inp, f"{key}/params/")
        opt = (adamw8_init if tc["optimizer"] == "adamw8" else adamw_init)(params)
        pspecs = shlib.param_specs(mesh, params)
        params = jax.device_put(params, shlib.named(mesh, pspecs))
        ospecs = (shlib.opt8_specs if tc["optimizer"] == "adamw8" else shlib.opt_specs)(mesh, opt, pspecs)
        opt = jax.device_put(opt, shlib.named(mesh, ospecs))
        step = jax.jit(step_fn)
        metrics = []
        for s in range(case["steps"]):
            params, opt, m = step(params, opt, batch_of(inp, key, s, mesh))
            metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
    out[f"{key}/metrics"] = np.asarray(metrics, np.float64)
    flat(params, f"{key}/params/", out)
    if tc["optimizer"] == "adamw8":
        flat({"m": opt["m"], "v": opt["v"]}, f"{key}/opt/", out)


def prefill(key, case, inp, out):
    cfg = config(case)
    lm = LM(cfg)
    mesh = make_mesh(case["mesh"])
    with mesh, logical_axis_rules(mesh):
        step_fn, params_sh = build_prefill_step(lm, mesh)
        params = jax.device_put(tree(inp, f"{key}/params/"), params_sh)
        logits = jax.jit(step_fn)(params, batch_of(inp, key, 0, mesh))
    out[f"{key}/logits"] = np.asarray(logits, np.float32)


def first_drops(key, case, inp, out):
    """The pairs the one-device gather dispatch drops in the loss of the
    case's first batch, from its initial parameters."""
    from _jax_sharded_reference import drops

    cfg = config(case)
    lm = LM(cfg)
    params = tree(inp, f"{key}/params/")
    batch = {n: jnp.asarray(inp[f"{key}/{n}0"]) for n in BATCH_KEYS if f"{key}/{n}0" in inp}
    out[f"{key}/drops"] = np.asarray(drops(cfg, lambda: jax.jit(lambda p, b: lm.loss(p, b)[0])(params, batch)))


def main(workdir):
    from _jax_sharded_reference import serve

    workdir = Path(workdir)
    cases = json.loads((workdir / "cases.json").read_text())
    inp = dict(np.load(workdir / "inputs.npz"))
    out = {}
    for key, case in cases.items():
        run = {"train": train, "prefill": prefill, "serve": serve}.get(case["kind"])
        if run is None:
            continue
        moe.set_moe_impl(case.get("moe_impl", "gather"))
        budget = shlib._SERVE_ZERO3_BUDGET
        shlib._SERVE_ZERO3_BUDGET = case.get("serve_zero3_budget", budget)
        try:
            run(key, case, inp, out)
            if "serve_zero3_budget" in case:
                specs = shlib.param_specs(make_mesh(case["mesh"]), LM(config(case)).abstract_params(), serve=True)
                out[f"{key}/embed_spec"] = np.asarray(json.dumps(list(specs["embed"])))
        finally:
            moe.set_moe_impl("gather")
            shlib._SERVE_ZERO3_BUDGET = budget
        if case.get("drops") and case["kind"] != "serve":
            first_drops(key, case, inp, out)
    np.savez(workdir / "reference.npz", **out)
    print("OK")


if __name__ == "__main__":
    main(sys.argv[1])
