"""The reference's side of ``tests/test_torch_sharded.py``, run as a
script under eight forced host devices (a 2 × 4 mesh, as the reference's
own sharded-decode and moe tests build it, and a 2 × 2 × 2 one with a pod
axis):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/_jax_sharded_reference.py DIR

Reads ``DIR/cases.json`` and ``DIR/inputs.npz`` (written by the test) and
writes ``DIR/reference.npz``: for each case the reference's sharded
function's outputs and its naive counterpart's — ``decode_attention_sharded``
against ``decode_attention`` (linear) and ``_ring_decode`` (ring),
``decode_mlp_sharded`` against ``layers.mlp``, ``mla_decode_sharded``
against ``mla_decode``, ``moe_layer`` under ``set_moe_impl("a2a")`` and
``("gather")`` with the aux loss and ``jax.grad`` of Σ y² + aux — and the
unsharded ``decode_step`` of four families (dense, hybrid, vlm, encdec)
over a given cache. ``serve`` runs the reference's own
``build_serve_step(lm, mesh, B, max_len)`` under a mesh (the moe and ssm
families' decode, XLA's partition of the whole step), its inputs placed
by the step's shardings, and ``drops`` counts the (token, choice) pairs
the reference's one-device gather dispatch drops on a function's way.
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
from repro.models import LM, decode, moe  # noqa: E402
from repro.models.attention import decode_attention, decode_attention_sharded, decode_mlp_sharded  # noqa: E402
from repro.models.decode import _ring_decode  # noqa: E402
from repro.models.layers import mlp  # noqa: E402
from repro.models.mla import mla_decode, mla_decode_sharded  # noqa: E402
from repro.runtime.pspec import logical_axis_rules  # noqa: E402


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
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)


def attention(key, case, inp, out):
    cfg, ring = config(case), case["kind"] == "ring"
    params = {w: jnp.asarray(inp[f"{key}/{w}"]) for w in ("wq", "wk", "wv", "wo")}
    if ring:
        naive = jax.jit(lambda x, k, v, p: _ring_decode(params, x, k, v, p, cfg, cfg.rope_theta))
    else:
        naive = jax.jit(lambda x, k, v, p: decode_attention(params, x, k, v, p, cfg))
    shard = jax.jit(lambda x, k, v, p: decode_attention_sharded(params, x, k, v, p, cfg, is_global=not ring,
                                                                ring=ring))
    start = (jnp.asarray(inp[f"{key}/k0"]), jnp.asarray(inp[f"{key}/v0"]))
    state = {"naive": start, "sharded": start}
    for t in case["steps"]:
        x = jnp.asarray(inp[f"{key}/x{t}"])
        for name, fn in (("naive", naive), ("sharded", shard)):
            y, kc, vc = fn(x, *state[name], jnp.int32(t))
            state[name] = (kc, vc)
            out[f"{name}/{key}/y{t}"] = np.asarray(y)
            out[f"{name}/{key}/k{t}"], out[f"{name}/{key}/v{t}"] = np.asarray(kc), np.asarray(vc)


def mlp_case(key, case, inp, out):
    cfg = config(case)
    names = ("w_gate", "w_up", "w_down") if cfg.mlp in ("swiglu", "geglu") else ("w_up", "w_down")
    p = {w: jnp.asarray(inp[f"{key}/{w}"]) for w in names}
    x = jnp.asarray(inp[f"{key}/x"])
    out[f"sharded/{key}/y"] = np.asarray(jax.jit(lambda x: decode_mlp_sharded(p, x, cfg))(x))
    out[f"naive/{key}/y"] = np.asarray(jax.jit(lambda x: mlp(p, x, cfg.mlp))(x))


def mla(key, case, inp, out):
    cfg = config(case)
    names = ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo")
    params = {w: jnp.asarray(inp[f"{key}/{w}"]) for w in names}
    z = (jnp.asarray(inp[f"{key}/c_kv0"]), jnp.asarray(inp[f"{key}/k_rope0"]))
    fns = {"naive": jax.jit(lambda x, c, r, p: mla_decode(params, x, c, r, p, cfg)),
           "sharded": jax.jit(lambda x, c, r, p: mla_decode_sharded(params, x, c, r, p, cfg))}
    state = {"naive": z, "sharded": z}
    for t in case["steps"]:
        x = jnp.asarray(inp[f"{key}/x{t}"])
        for name, fn in fns.items():
            y, c, r = fn(x, *state[name], jnp.int32(t))
            state[name] = (c, r)
            out[f"{name}/{key}/y{t}"] = np.asarray(y)
            out[f"{name}/{key}/c_kv{t}"], out[f"{name}/{key}/k_rope{t}"] = np.asarray(c), np.asarray(r)


def moe_case(key, case, inp, out):
    cfg = config(case)
    params = tree(inp, f"{key}/")
    x = params.pop("x")

    def loss_fn(p):
        y, aux = moe.moe_layer(p, x, cfg)
        return jnp.sum(jnp.square(y)) + aux

    for impl, name in (("gather", "naive"), ("a2a", "sharded")):
        moe.set_moe_impl(impl)
        y, aux = jax.jit(lambda p, x: moe.moe_layer(p, x, cfg))(params, x)
        out[f"{name}/{key}/y"], out[f"{name}/{key}/aux"] = np.asarray(y), np.asarray(aux)
        flat(jax.jit(jax.grad(loss_fn))(params), f"{name}/{key}/grad/", out)
    moe.set_moe_impl("gather")


def decode_step(key, case, inp, out):
    cfg, B, max_len = config(case), case["B"], case["max_len"]
    lm, params = LM(cfg), tree(inp, f"{key}/params/")
    cache = {k[len(f"{key}/cache/"):]: jnp.asarray(inp[k]) for k in inp if k.startswith(f"{key}/cache/")}
    step = jax.jit(lambda p, t, c, pos: decode.decode_step(lm, p, t, c, pos))
    toks = inp[f"{key}/tokens"]
    for n, pos in enumerate(case["steps"]):
        logits, cache = step(params, jnp.asarray(toks[:, n:n + 1]), cache, jnp.int32(pos))
        out[f"naive/{key}/logits{pos}"] = np.asarray(logits)
    for k, v in cache.items():
        out[f"naive/{key}/cache_after/{k}"] = np.asarray(v)


def drops(cfg, fn) -> int:
    """The (token, choice) pairs past the capacity that the reference's
    gather dispatch drops in ``fn()`` (jitted, on one device): its
    ``_positions_in_expert`` spied on, each call's count sent back by a
    debug callback."""
    counts = []
    orig = moe._positions_in_expert

    def spy(idx, E):
        pos = orig(idx, E)
        T, K = idx.shape
        C = max(8, int(T * K * cfg.capacity_factor / E))
        jax.debug.callback(lambda p: counts.append(int((np.asarray(p) >= C).sum())), pos)
        return pos

    moe._positions_in_expert = spy
    try:
        jax.block_until_ready(fn())
        jax.effects_barrier()
    finally:
        moe._positions_in_expert = orig
    return sum(counts)


def serve(key, case, inp, out):
    """The reference's ``build_serve_step`` under the case's mesh: the
    parameters, the cache (drawn in the inputs) and each step's tokens
    placed by its shardings; each step's logits and the cache after."""
    from repro.runtime.serve import build_serve_step

    cfg, B, max_len = config(case), case["B"], case["max_len"]
    lm = LM(cfg)
    moe.set_moe_impl(case.get("moe_impl", "gather"))
    shape = case["mesh"]
    mesh = jax.make_mesh(tuple(shape.values()), tuple(shape), axis_types=(jax.sharding.AxisType.Auto,) * len(shape))
    toks = inp[f"{key}/tokens"]
    try:
        with mesh, logical_axis_rules(mesh):
            step_fn, (psh, csh, tsh, pos_sh), _ = build_serve_step(lm, mesh, B, max_len)
            params = jax.device_put(tree(inp, f"{key}/params/"), psh)
            cache = jax.device_put(tree(inp, f"{key}/cache/"), csh)
            step = jax.jit(step_fn)
            for n, pos in enumerate(case["steps"]):
                logits, cache = step(params, cache, jax.device_put(jnp.asarray(toks[:, n:n + 1]), tsh),
                                     jax.device_put(jnp.int32(pos), pos_sh))
                out[f"serve/{key}/logits{pos}"] = np.asarray(logits)
        flat(cache, f"serve/{key}/cache_after/", out)
        if cfg.family == "moe":
            params = tree(inp, f"{key}/params/")
            one = jax.jit(lambda p, t, c, pos: decode.decode_step(lm, p, t, c, pos))

            def steps():
                c = tree(inp, f"{key}/cache/")
                for n, pos in enumerate(case["steps"]):
                    logits, c = one(params, jnp.asarray(toks[:, n:n + 1]), c, jnp.int32(pos))
                return logits

            out[f"serve/{key}/drops"] = np.asarray(drops(cfg, steps))
    finally:
        moe.set_moe_impl("gather")


RUN = {"linear": attention, "ring": attention, "mlp": mlp_case, "mla": mla, "moe": moe_case}


def main(workdir):
    """Each case under its own mesh (the decode steps unsharded)."""
    workdir = Path(workdir)
    cases = json.loads((workdir / "cases.json").read_text())
    inp = np.load(workdir / "inputs.npz")
    out = {}
    for key, case in cases.items():
        if case["kind"] == "decode":
            decode_step(key, case, inp, out)
        elif case["kind"] in RUN:
            shape = case["mesh"]
            mesh = jax.make_mesh(tuple(shape.values()), tuple(shape),
                                 axis_types=(jax.sharding.AxisType.Auto,) * len(shape))
            with mesh, logical_axis_rules(mesh):
                RUN[case["kind"]](key, case, inp, out)
    np.savez(workdir / "reference.npz", **out)
    print("OK")


if __name__ == "__main__":
    main(sys.argv[1])
