"""Logical-axis sharding rules (MaxText-style) with divisibility fallback,
as functions of a mesh's shape (the port of ``repro.runtime.pspec``).

A mesh here is an ordered mapping of axis name → size: a shapes-only
one (``launch.mesh.make_production_mesh``) or one placed over a process
group (``launch.mesh.make_mesh``), which reads the same way. Model code may
annotate tensors with *logical* axes (``shard(x, 'batch', 'seq',
'embed')``); a context (``logical_axis_rules``) maps logical axes to mesh
axes, and ``spec_for`` gives each dimension's mesh axis, a tuple of axes
or None. A logical axis drops to replicated when the dimension does not
divide the mesh axes (e.g. 10 heads on a 16-way 'model' axis).

``current_mesh()`` is the mesh of the innermost context. Under a placed
mesh the decode step takes the sharded paths (``models.decode``): each
rank runs the reference's ``shard_map`` bodies on its own blocks, so there
are no ``Manual`` axes to skip. ``shard`` is a no-op: a rank's tensors are
its blocks already, and the port's models do not call it.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

__all__ = ["logical_axis_rules", "shard", "spec_for", "DEFAULT_RULES", "current_mesh"]

_state = threading.local()

# logical axis → preferred mesh axes (first that divides wins; tuples
# mean "shard over the product of these axes").
DEFAULT_RULES: dict[str, tuple] = {
    "batch": (("pod", "data"), ("data",)),
    "seq": (("model",),),               # decode KV-cache sequence sharding
    "embed": (("data",),),              # FSDP: param d_in over data
    "heads": (("model",),),
    "kv": (("model",),),
    "ff": (("model",),),
    "vocab": (("model",),),
    "expert": (("model",),),
    "capacity": (("data",),),
    "lru": (("model",),),
    "ssm_heads": (("model",),),
    "image": (),
    "layers": (),
    "none": (),
}


def current_mesh() -> Optional[dict]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def logical_axis_rules(mesh: dict, rules: Optional[dict] = None):
    prev = (getattr(_state, "mesh", None), getattr(_state, "rules", None))
    _state.mesh = mesh
    _state.rules = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def _resolve(mesh: dict, dim: int, logical: Optional[str]):
    """Pick the first rule candidate whose mesh-axis product divides dim."""
    if logical is None:
        return None
    rules = getattr(_state, "rules", None) or DEFAULT_RULES
    for cand in rules.get(logical, ()):
        axes = tuple(a for a in cand if a in mesh)
        if not axes:
            continue
        size = math.prod(mesh[a] for a in axes)
        if size > 1 and dim % size == 0:
            return axes if len(axes) > 1 else axes[0]
    return None


def spec_for(mesh: dict, shape: Sequence[int], axes: Sequence[Optional[str]]) -> tuple:
    """Each dimension's mesh axis (a name, a tuple of names, or None); a
    mesh axis is used by one dimension at most."""
    assert len(shape) == len(axes), (shape, axes)
    used: set[str] = set()
    parts = []
    for dim, ax in zip(shape, axes):
        r = _resolve(mesh, dim, ax)
        flat = (r if isinstance(r, tuple) else (r,)) if r else ()
        if any(a in used for a in flat):
            r = None
        used.update(flat)
        parts.append(r)
    return tuple(parts)


def shard(x, *axes: Optional[str]):
    """``x`` unchanged: one device (see the module note)."""
    return x
