"""The port's side of ``tests/test_torch_sharded.py``: what each rank of
the 2 × 4 gloo mesh runs (spawned by ``launch.mesh.run_ranks``, so it
lives in a module the ranks import; it imports no JAX).

``run(mesh, workdir)`` reads the cases (``cases.json``) and the inputs
(``inputs.npz``) that the test wrote, cuts this rank's blocks by the
sharded functions' own specs, runs every case of this mesh's shape and
returns its results as NumPy arrays, keyed as the reference's script
keys its outputs: the test holds each rank's block against the same
block of the reference's global result (``runtime.sharding.local_block``
at the rank's coordinates). ``serve`` is ``build_serve_step`` under the
mesh over a cache filled from the inputs, any family's (the moe family's
nested caches too), shared with ``_torch_sharded_train_ranks``.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import all_reduce
from repro_torch.models import LM, decode, moe, params_from_reference
from repro_torch.models.attention import (decode_attention_sharded, decode_attention_specs, decode_mlp_sharded,
                                          decode_mlp_specs)
from repro_torch.models.mla import mla_decode_sharded, mla_decode_specs
from repro_torch.runtime.pspec import logical_axis_rules
from repro_torch.runtime.serve import build_serve_step
from repro_torch.runtime.sharding import local_block, spec_axes


def config(case: dict):
    return get_config(case["arch"], reduced=True).replace(**case["over"])


def _cut(a, spec, mesh) -> torch.Tensor:
    return local_block(torch.from_numpy(np.ascontiguousarray(a)), tuple(spec), mesh).clone()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().copy()


def _attention(mesh, key, case, inp, out):
    cfg, B, ring = config(case), case["B"], case["kind"] == "ring"
    specs = decode_attention_specs(cfg, mesh, B)
    params = {w: _cut(inp[f"{key}/{w}"], specs[w], mesh) for w in ("wq", "wk", "wv", "wo")}
    kc, vc = (_cut(inp[f"{key}/{kv}0"], specs["cache"], mesh) for kv in "kv")
    for t in case["steps"]:
        x = _cut(inp[f"{key}/x{t}"], specs["x"], mesh)
        y, kc, vc = decode_attention_sharded(params, x, kc, vc, t, cfg, batch=B, is_global=not ring, ring=ring)
        out[f"{key}/y{t}"], out[f"{key}/k{t}"], out[f"{key}/v{t}"] = _np(y), _np(kc), _np(vc)


def _mlp(mesh, key, case, inp, out):
    cfg, B = config(case), case["B"]
    specs = decode_mlp_specs(cfg, mesh, B)
    names = ("w_gate", "w_up", "w_down") if cfg.mlp in ("swiglu", "geglu") else ("w_up", "w_down")
    params = {w: _cut(inp[f"{key}/{w}"], specs[w], mesh) for w in names}
    out[f"{key}/y"] = _np(decode_mlp_sharded(params, _cut(inp[f"{key}/x"], specs["x"], mesh), cfg, batch=B))


def _mla(mesh, key, case, inp, out):
    cfg, B = config(case), case["B"]
    specs = mla_decode_specs(cfg, mesh, B)
    params = {w: _cut(inp[f"{key}/{w}"], specs[w], mesh) for w in specs if w not in ("x", "cache")}
    ckv, kr = (_cut(inp[f"{key}/{name}0"], specs["cache"], mesh) for name in ("c_kv", "k_rope"))
    for t in case["steps"]:
        x = _cut(inp[f"{key}/x{t}"], specs["x"], mesh)
        y, ckv, kr = mla_decode_sharded(params, x, ckv, kr, t, cfg, batch=B)
        out[f"{key}/y{t}"], out[f"{key}/c_kv{t}"], out[f"{key}/k_rope{t}"] = _np(y), _np(ckv), _np(kr)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _moe(mesh, key, case, inp, out):
    """The a2a dispatch and the gather dispatch of the sharded batch
    (``moe_layer`` under the placed mesh, the a2a's layout), each one's aux
    and the gradients of Σ y² + aux: each rank's loss is its tokens' Σ y²
    plus aux / world, so that the ranks' losses sum to the global loss; a
    parameter's gradient is then summed over the mesh axes its block is
    replicated on. The a2a's under ``key``, the gather's under
    ``key/gather``."""
    cfg = config(case)
    specs = moe.moe_a2a_specs(cfg, mesh)
    world = int(np.prod(list(mesh.values())))
    for impl, at in (("a2a", key), ("gather", f"{key}/gather")):
        params = {}
        for name, spec in _leaves({k: v for k, v in specs.items() if k != "x"}):
            leaf = _cut(inp[f"{key}/{name}"], spec, mesh).requires_grad_(True)
            *path, last = name.split("/")
            node = params
            for p in path:
                node = node.setdefault(p, {})
            node[last] = leaf
        x = _cut(inp[f"{key}/x"], specs["x"], mesh)
        moe.set_moe_impl(impl)
        try:
            with logical_axis_rules(mesh):
                y, aux = moe.moe_layer(params, x, cfg)
                (torch.sum(torch.square(y)) + aux / world).backward()
        finally:
            moe.set_moe_impl("gather")
        out[f"{at}/y"], out[f"{at}/aux"] = _np(y), _np(aux)
        with torch.no_grad():
            for name, spec in _leaves({k: v for k, v in specs.items() if k != "x"}):
                node = params
                for p in name.split("/"):
                    node = node[p]
                g = node.grad
                used = {a for e in spec for a in spec_axes(e)}
                for ax in mesh:
                    if ax not in used:
                        g = all_reduce(g, ax, mesh)
                out[f"{at}/grad/{name}"] = _np(g)


def cross_inputs(cfg, case: dict, rows: int, device) -> dict:
    """``init_cache``'s cross-attention input for ``rows`` of the batch:
    vlm's image embeddings, encdec's audio frames (the case's ``frames``,
    else max_len; zeros: the test overwrites the cross K/V with the
    inputs' rows)."""
    if cfg.family == "vlm":
        return {"image_embeds": torch.zeros(rows, cfg.num_image_tokens, cfg.d_model, device=device)}
    if cfg.family == "encdec":
        return {"audio_embeds": torch.zeros(rows, case.get("frames") or case["max_len"], cfg.d_model, device=device)}
    return {}


def _tree(inp, prefix: str) -> dict:
    """The reference's parameter tree (NumPy leaves) stored flat under ``prefix``."""
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


def _walk(tree, prefix=""):
    """(flat '/' key, leaf) of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _at(tree, key: str):
    for k in key.split("/"):
        tree = tree[k]
    return tree


COUNTERS = ("attention", "mlp", "mla", "moe", "cross", "rglru", "mamba", "gathered")


def _counters():
    from repro_torch.models import attention, mla, rglru, ssm

    return (attention.decode_attention_sharded, attention.decode_mlp_sharded, mla.mla_decode_sharded,
            moe.moe_gather_sharded, attention.cross_decode_sharded, rglru.rglru_decode_sharded,
            ssm.mamba_decode_sharded, decode.gathered_layer)


def serve(mesh, key, case, inp, out):
    """build_serve_step under the mesh over a cache filled from the inputs
    (nested caches by their '/' paths; vlm's and encdec's cross K/V too,
    ``init_cache`` run first on zero embeddings of the rank's rows): each
    step's logits rows, the cache blocks after the last step, the specs,
    the bytes of the rank's parameters and caches (``held``), and each
    step's layers by the way they ran (``COUNTERS``). A case with
    ``baseline`` runs with ``REPRO_SHARDED_DECODE=0``."""
    import os

    cfg, B, max_len = config(case), case["B"], case["max_len"]
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, _tree(inp, f"{key}/params/")))
    prev = os.environ.get("REPRO_SHARDED_DECODE")
    if case.get("baseline"):
        os.environ["REPRO_SHARDED_DECODE"] = "0"
    try:
        step, (psh, csh, tsh, _), _ = build_serve_step(lm, B, max_len, mesh=mesh, frames=case.get("frames"))
        rows = local_block(torch.empty(B), tsh[:1], mesh).shape[0]
        with logical_axis_rules(mesh):
            cache = decode.init_cache(lm, B, max_len, **cross_inputs(cfg, case, rows, "cpu"))
        for k, t in _walk(cache):
            t.copy_(_cut(inp[f"{key}/cache/{k}"], _at(csh, k), mesh))
        toks = inp[f"{key}/tokens"]
        calls = []
        for n, pos in enumerate(case["steps"]):
            before = [f.calls for f in _counters()]
            logits, cache = step(_cut(toks[:, n:n + 1], tsh, mesh), cache, pos)
            calls.append([f.calls - b for f, b in zip(_counters(), before)])
            out[f"{key}/logits{pos}"] = _np(logits)
    finally:
        if prev is None:
            os.environ.pop("REPRO_SHARDED_DECODE", None)
        else:
            os.environ["REPRO_SHARDED_DECODE"] = prev
    for k, t in _walk(cache):
        out[f"{key}/cache_after/{k}"] = _np(t)
    out[f"{key}/serve_calls"] = np.array(calls)
    out[f"{key}/held"] = np.array([sum(p.numel() * p.element_size() for p in step.lm.parameters()),
                                   sum(t.numel() * t.element_size() for _, t in _walk(cache))])
    out[f"{key}/cache_specs"] = np.array(json.dumps(csh))
    out[f"{key}/param_specs"] = np.array(json.dumps(psh))


def cross_blocks(mesh, key, case, inp, out):
    """``init_cache`` under the mesh from the case's image embeddings or
    audio frames (the rank's rows): its blocks of the cross K/V, which the
    test holds against the same blocks of the unsharded ``init_cache``,
    and the specs that cut them."""
    from repro_torch.models.attention import _decode_bspec

    cfg, B, max_len = config(case), case["B"], case["max_len"]
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_reference(cfg, _tree(inp, f"{key}/params/")))
    name = "image_embeds" if cfg.family == "vlm" else "audio_embeds"
    src = _cut(inp[f"{key}/{name}"], (_decode_bspec(mesh, B), None, None), mesh)
    with logical_axis_rules(mesh):
        cache = decode.init_cache(lm, B, max_len, **{name: src})
        csh = decode.cache_blocks(lm, B, max_len, frames=src.shape[1] if cfg.family == "encdec" else None)
    for k in ("cross_k", "cross_v"):
        out[f"{key}/{k}"] = _np(cache[k])
    out[f"{key}/cache_specs"] = np.array(json.dumps(csh))


def _gather_runs(mesh, cfg):
    """The gather dispatch of a sharded batch through ``moe_layer``, on
    zero blocks of ``moe_a2a_specs``' layout."""
    specs = moe.moe_a2a_specs(cfg, mesh)
    whole = {"router": (cfg.d_model, cfg.num_experts), "w_gate": (cfg.num_experts, cfg.d_model, cfg.moe_d_ff),
             "w_up": (cfg.num_experts, cfg.d_model, cfg.moe_d_ff), "w_down": (cfg.num_experts, cfg.moe_d_ff, cfg.d_model)}
    params = {n: local_block(torch.zeros(s), specs[n], mesh) for n, s in whole.items()}
    x = local_block(torch.zeros(2, 8, cfg.d_model), specs["x"], mesh)
    moe.set_moe_impl("gather")
    return moe.moe_layer(params, x, cfg)


def _refusals(mesh, key, case, inp, out):
    """What the port refuses under a placed mesh, as messages (empty where
    it runs): a cache layout that runtime.sharding.cache_specs would cut
    otherwise than the sharded attention reads it (reduced gemma2 at B 2:
    the batch rule takes its 2 periods for the batch), the gather dispatch
    of a sharded batch, and the moe family's decode caches."""
    msgs = []
    with logical_axis_rules(mesh):
        for fn in (lambda: decode.init_cache(LM(config(case["dense"]), device="meta"), 2, 1024),
                   lambda: _gather_runs(mesh, config(case["moe"])),
                   lambda: decode.init_cache(LM(config(case["moe"]), device="meta"), 4, 1024)):
            try:
                fn()
                msgs.append("")
            except (ValueError, NotImplementedError) as e:
                msgs.append(f"{type(e).__name__}: {e}")
    out[f"{key}/messages"] = np.array(msgs)


RUN = {"linear": _attention, "ring": _attention, "mlp": _mlp, "mla": _mla, "moe": _moe, "decode": serve,
       "refusals": _refusals, "cross_blocks": cross_blocks}


def run(mesh, workdir: str) -> dict:
    workdir = Path(workdir)
    cases = json.loads((workdir / "cases.json").read_text())
    inp = np.load(workdir / "inputs.npz")
    out = {"coords": np.array([mesh.coords[a] for a in mesh])}
    for key, case in cases.items():
        if case["mesh"] == dict(mesh):
            grad = torch.enable_grad() if case["kind"] == "moe" else torch.no_grad()
            with logical_axis_rules(mesh), grad:
                RUN[case["kind"]](mesh, key, case, inp, out)
    return out
