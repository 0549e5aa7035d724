"""Production mesh shapes, as plain ordered axis → size mappings (the
port of ``repro.launch.mesh``).

Nothing here touches a device or creates a process group: the port runs
one device, and the shapes feed ``runtime.sharding``'s rules and the dry
run's per-device figures. Placing a program on such a mesh comes with
the sharded paths (ROADMAP.md, queue A12.5).
"""
from __future__ import annotations

__all__ = ["make_production_mesh", "mesh_from_arg"]


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """16×16 = 256 devices per pod; multi-pod adds the 2-pod axis."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def mesh_from_arg(arg: str) -> dict:
    """``single`` | ``multi`` | ``AxB[xC]`` (the trailing axes of
    pod, data, model, as ``repro.launch.dryrun._make_mesh`` reads them);
    ``1`` is one H100."""
    if arg == "single":
        return make_production_mesh(multi_pod=False)
    if arg == "multi":
        return make_production_mesh(multi_pod=True)
    dims = tuple(int(x) for x in arg.split("x"))
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise ValueError(f"mesh {arg!r}: expected single, multi or AxB[xC] of positive sizes")
    axes = ("pod", "data", "model")[-len(dims):]
    return dict(zip(axes, dims))
