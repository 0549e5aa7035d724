"""Sharding specs for parameters, optimizer state, batches and decode
caches, as rules on a mesh's shape (the port of ``repro.runtime.sharding``).

A mesh is an ordered mapping axis name → size
(``launch.mesh.make_production_mesh``); a spec is a tuple with one entry a
dimension: a mesh axis, a tuple of axes (the product shards it) or None.

Policy (TP × ZeRO-3, pods pure-DP), as the reference's:
  • params: the largest mesh-divisible dim shards over 'model'
    (Megatron TP), the next over 'data' (ZeRO-3 / FSDP). Replicated
    over 'pod'.
  • batches: global batch over ('pod', 'data').
  • caches: the batch-sized dim → 'data'; the longest remaining
    divisible dim (the KV sequence) → 'model'.
Indivisible dims fall back to replicated.

The rules apply to the port's parameters, one a layer, where the
reference stacks a family's layers on leading axes
(``models.interop.STACKED``): ``<stack>.<i>[.<j>].<rest>`` is a slice of
the reference's ``<stack>/<rest>`` leaf, and its spec is that leaf's spec
with the stacked axes dropped (the reference never shards them). Every
rule reads only the leaf's unstacked dimensions, which are the port
parameter's own.

``local_block``/``local_blocks`` are the counterpart of the reference's
``named``/``tree_shardings``: where the reference hands XLA a
``NamedSharding`` and lets it place the global array, a rank of a placed
mesh (``launch.mesh.make_mesh``) cuts its own block of a full tensor by
the spec and its coordinates. A dimension sharded over a tuple of axes
shards over their product with the tuple's first axis major, as JAX lays
out ``P(("model", "data"))`` (model-major; ``("pod", "data")`` is the mesh's
own order). ``gather_blocks`` is their inverse, a collective: every
rank's blocks gathered back into the whole tensors, a leaf at a time,
onto the host of the ranks that keep them (for checkpoints and tests).
``opt_state_specs`` picks the optimizer state's specs (``opt_specs`` or
``opt8_specs``) and ``block_shape`` gives a block's shape, from which a
rank allocates its blocks of a state it never holds whole.
``per_device_bytes`` gives the bytes a device would hold under a spec,
which the dry run reports.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from ..launch.mesh import gather_dims, spec_axes
from ..optim.adamw import stack_position

__all__ = ["param_specs", "opt_specs", "opt8_specs", "batch_specs", "cache_specs", "cache_spec", "needs_zero3",
           "per_device_bytes", "tree_map", "local_block", "local_blocks", "gather_blocks", "block_index",
           "block_shape", "spec_axes", "opt_state_specs", "batch_axes"]

def _axis_size(mesh: dict, name: str) -> int:
    return mesh.get(name, 1)


# Semantic per-dim roles by leaf name: 'out' = output-feature dim →
# 'model' (Megatron column/row parallel); 'in' = input-feature dim →
# 'data' (ZeRO-3: gathered per layer). Keyed (name, ndim-after-stack).
_ROLE_RULES: dict[tuple[str, int], tuple] = {
    ("wq", 3): ("in", "out", None), ("wk", 3): ("in", "out", None),
    ("wv", 3): ("in", "out", None), ("wo", 3): ("out", None, "in"),
    ("w_gate", 2): ("in", "out"), ("w_up", 2): ("in", "out"),
    ("w_down", 2): ("out", "in"),
    # MoE experts: E is expert-parallel over 'model'
    ("w_gate", 3): ("out", "in", None), ("w_up", 3): ("out", "in", None),
    ("w_down", 3): ("out", None, "in"),
    ("embed", 2): ("out", "in"), ("unembed", 2): ("out", "in"),
    ("router", 2): ("in", None),
    ("wq_a", 2): ("in", None), ("wq_b", 3): (None, "out", None),
    ("wkv_a", 2): ("in", None), ("wkv_b", 3): (None, "out", None),
    ("in_proj", 2): ("in", "out"), ("out_proj", 2): ("out", "in"),
    ("conv_w", 2): (None, "out"),
    ("w_x", 2): ("in", "out"), ("w_r", 2): (None, "out"),
    ("w_i", 2): (None, "out"), ("out", 2): ("out", "in"),
}


def _keys(name: str) -> list[str]:
    """The reference's path of the leaf that parameter ``name`` slices."""
    pos = stack_position(name)
    return list(pos[0]) if pos else name.split(".")


def _param_spec(mesh: dict, name: str, shape, zero3: bool) -> tuple:
    keys = _keys(name)
    n = len(shape)
    assign: list = [None] * n
    model, data = _axis_size(mesh, "model"), _axis_size(mesh, "data")
    role_axis = {"out": ("model", model), "in": ("data", data)}
    leaf = keys[-1] if keys else ""
    # routed experts: 2-D expert parallelism when E divides the whole
    # (model×data) mesh — weights fully resident, no per-layer gathers
    if ("moe" in keys and leaf in ("w_gate", "w_up", "w_down") and n == 3
            and model * data > 1 and shape[0] % max(model * data, 1) == 0):
        assign[0] = ("model", "data")
        return tuple(assign)
    roles = _ROLE_RULES.get((leaf, n))
    if roles is None and n >= 2:
        # default: last dim column-parallel, first body dim ZeRO-sharded
        roles = ("in",) + (None,) * (n - 2) + ("out",)
    if roles:
        for i, role in enumerate(roles):
            if role is None:
                continue
            if role == "in" and not zero3:
                continue        # small models replicate over 'data'
            ax, sz = role_axis[role]
            if sz > 1 and shape[i] % sz == 0 and shape[i] >= sz:
                assign[i] = ax
    return tuple(assign)


# Serving keeps params TP-only (replicated over 'data') while bf16
# params fit this budget.
_SERVE_ZERO3_BUDGET = 8 * 2**30


def _named_shapes(params) -> dict:
    """name → shape of a parameter mapping (tensors or shapes) or module."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}


def needs_zero3(mesh: dict, params, *, serve: bool = False) -> bool:
    """Training always ZeRO-shards (optimizer moments dominate memory);
    serving shards over 'data' only when TP-only params don't fit."""
    if not serve:
        return True
    n_params = sum(math.prod(s) for s in _named_shapes(params).values())
    model = max(_axis_size(mesh, "model"), 1)
    return 2.0 * n_params / model > _SERVE_ZERO3_BUDGET


def param_specs(mesh: dict, params, zero3: Optional[bool] = None, *, serve: bool = False) -> dict:
    """name → spec for every parameter of ``params`` (an ``LM``, or a
    mapping of names to tensors or shapes)."""
    shapes = _named_shapes(params)
    if zero3 is None:
        zero3 = needs_zero3(mesh, shapes, serve=serve)
    return {k: _param_spec(mesh, k, s, zero3) for k, s in shapes.items()}


def opt_specs(mesh: dict, opt: dict, pspecs: dict) -> dict:
    """Moments share the param specs; the step replicates."""
    return {"m": pspecs, "v": pspecs, "step": ()}


def opt8_specs(mesh: dict, opt: dict, pspecs: dict) -> dict:
    """int8-moment state inherits the parameter sharding: the last
    param dim splits into (nb, b) — its mesh axis rides on nb."""

    def spec_pair(pspec: tuple, mleaf: dict) -> dict:
        qshape = tuple(mleaf["q"].shape)
        plist = list(pspec)
        while len(plist) < len(qshape) - 1:
            plist.append(None)
        # drop axes that no longer divide the block layout
        for i, ax in enumerate(plist):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            if qshape[i] % math.prod(mesh.get(a, 1) for a in axes) != 0:
                plist[i] = None
        return {"q": (*plist[:-1], plist[-1], None), "scale": tuple(plist)}

    return {"m": {k: spec_pair(pspecs[k], m) for k, m in opt["m"].items()},
            "v": {k: spec_pair(pspecs[k], v) for k, v in opt["v"].items()},
            "step": ()}


def opt_state_specs(mesh: dict, opt: dict, pspecs: dict, optimizer: str = "adamw") -> dict:
    """The specs of optimizer state ``opt`` (a tree of tensors or ``meta``
    tensors of the whole state) for parameter specs ``pspecs``: AdamW's
    moments as their parameters, adamw8's codes and scales by
    ``opt8_specs``."""
    if optimizer not in ("adamw", "adamw8"):
        raise ValueError(f"optimizer must be 'adamw' or 'adamw8', got {optimizer!r}")
    return (opt8_specs if optimizer == "adamw8" else opt_specs)(mesh, opt, pspecs)


def tree_map(fn, tree):
    """``fn`` over every tensor of a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def batch_specs(mesh: dict, batch, *, pod_manual: bool = False):
    """The global batch over ('pod', 'data') where it divides, else
    'data', else replicated; pod_manual keeps it off 'pod'."""
    pod, data = _axis_size(mesh, "pod"), _axis_size(mesh, "data")

    def spec(leaf):
        B = leaf.shape[0]
        if not pod_manual and pod > 1 and B % (pod * data) == 0:
            bx: Any = ("pod", "data")
        elif B % data == 0 and data > 1:
            bx = "data"
        else:
            bx = None
        return (bx, *([None] * (leaf.dim() - 1)))

    return tree_map(spec, batch)


def batch_axes(mesh: dict) -> tuple:
    """The mesh axes a sharded step's batch rows are split over, pod-major
    (``batch_specs`` of a batch they divide)."""
    return tuple(a for a in ("pod", "data") if _axis_size(mesh, a) > 1)


def cache_spec(mesh: dict, shape, batch_size: int, batch_dim: int | None = None) -> tuple:
    """One cache leaf's spec: the batch-sized dim over the batch axes
    (('pod', 'data') where both divide it, else 'data'; skipped when
    batch_size is 1), then the longest remaining dim that divides 'model'
    over 'model'. The batch-sized dim is ``batch_dim`` where given, else
    the first dim equal to batch_size, as the reference picks it (a
    stacked layer axis as long as the batch comes first then)."""
    model, data = _axis_size(mesh, "model"), _axis_size(mesh, "data")
    pod = _axis_size(mesh, "pod")
    shape = tuple(shape)
    assign: list = [None] * len(shape)
    bdim = None
    if batch_size > 1:
        for i in ([batch_dim] if batch_dim is not None else range(len(shape))):
            s = shape[i]
            if s != batch_size:
                continue
            if pod > 1 and s % (pod * data) == 0:
                bdim = i
                assign[i] = ("pod", "data")
            elif data > 1 and s % data == 0:
                bdim = i
                assign[i] = "data"
            if bdim is not None:
                break
    # sequence (or widest) dim over 'model'
    order = sorted((i for i in range(len(shape)) if i != bdim), key=lambda i: -shape[i])
    for i in order:
        if model > 1 and shape[i] % model == 0 and shape[i] >= model:
            assign[i] = "model"
            break
    return tuple(assign)


def cache_specs(mesh: dict, cache, batch_size: int):
    """``cache_spec`` of every leaf of a cache tree, the reference's rule."""
    return tree_map(lambda leaf: cache_spec(mesh, leaf.shape, batch_size), cache)


def block_index(mesh, entry, coords: dict) -> tuple[int, int]:
    """(index of the block, number of blocks) along a dimension whose spec
    entry is ``entry``, for the rank at ``coords`` (axis → coordinate): the
    entry's axes row-major, the first one major."""
    idx, n = 0, 1
    for a in spec_axes(entry):
        idx = idx * mesh[a] + coords[a]
        n *= mesh[a]
    return idx, n


def local_block(x: torch.Tensor, spec: tuple, mesh, coords: dict | None = None) -> torch.Tensor:
    """The block of the full tensor ``x`` that the rank at ``coords`` (by
    default this rank's, ``mesh.coords``) holds under ``spec``: each
    sharded dimension cut into equal blocks over its axes. A view of
    ``x`` where the cut allows one, else a copy; raises where a sharded
    dimension does not divide."""
    coords = mesh.coords if coords is None else coords
    if len(spec) != x.dim():
        raise ValueError(f"local_block: spec {spec} for a tensor of shape {tuple(x.shape)}")
    for dim, entry in enumerate(spec):
        idx, n = block_index(mesh, entry, coords)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"local_block: dimension {dim} of {tuple(x.shape)} does not divide over {entry}")
        blk = x.shape[dim] // n
        x = x.narrow(dim, idx * blk, blk)
    return x


def local_blocks(tree, specs, mesh, coords: dict | None = None):
    """``local_block`` over a nested dict of tensors and the dict of specs
    of the same structure (``tree_shardings``' counterpart)."""
    if isinstance(tree, dict):
        return {k: local_blocks(v, specs[k], mesh, coords) for k, v in tree.items()}
    return local_block(tree, specs, mesh, coords)


@torch.no_grad()
def gather_blocks(tree, specs, mesh, keep: bool = True):
    """The whole tensors of which ``tree`` (a tensor or a nested dict of
    them) holds this rank's blocks under ``specs`` (the same structure),
    ``local_blocks``' inverse, on the host where ``keep`` (a checkpoint's
    writer) and None elsewhere. Collective: every rank of the mesh calls it
    with the same structure. One leaf at a time, each whole leaf moved to
    the host or dropped at once, so that no device holds more than one
    whole leaf beside its blocks."""
    if isinstance(tree, dict):
        out = {k: gather_blocks(v, specs[k], mesh, keep) for k, v in tree.items()}
        return out if keep else None
    whole = gather_dims(tree.detach(), specs, mesh)
    return whole.cpu() if keep else None


def block_shape(shape, spec: tuple, mesh: dict) -> tuple:
    """The shape of a rank's block of a tensor of ``shape`` under ``spec``;
    raises where a sharded dimension does not divide."""
    out = list(shape)
    for i, entry in enumerate(spec):
        n = math.prod(mesh.get(a, 1) for a in spec_axes(entry))
        if out[i] % n:
            raise ValueError(f"block_shape: dimension {i} of {tuple(shape)} does not divide over {entry}")
        out[i] //= n
    return tuple(out)


def per_device_bytes(mesh: dict, t: torch.Tensor, spec: tuple) -> int:
    """Bytes one device holds of ``t`` sharded by ``spec``: each sharded
    dimension divided by the product of its axes' sizes."""
    shape = list(t.shape)
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        shape[i] //= math.prod(mesh.get(a, 1) for a in axes)
    return math.prod(shape) * t.element_size()
