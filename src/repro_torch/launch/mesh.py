"""Meshes (the port of ``repro.launch.mesh``): production shapes as plain
ordered axis → size mappings, and meshes placed over a
``torch.distributed`` process group, with the collectives the sharded
decode paths run along one axis.

A shapes-only mesh (``make_production_mesh``, ``mesh_from_arg``) touches
no device and no process group: it feeds ``runtime.sharding``'s rules and
the dry run's per-device figures. ``make_mesh`` builds a
``torch.distributed.device_mesh.DeviceMesh`` over a process group the
caller has initialised, one rank a device, and returns a ``Mesh``: the
same axis → size mapping, plus each axis's process group and this rank's
coordinate on it. ``runtime.pspec.logical_axis_rules(mesh)`` makes it the
current mesh; the sharded decode paths (``models.attention``,
``models.mla``, ``models.moe``) run inside it on each rank's blocks, as the
reference's ``shard_map`` bodies do, and call:

  ``all_reduce``  psum (``op="sum"``) or pmax (``op="max"``) over an axis,
                  or over the whole mesh with ``axis=None``
  ``all_gather``  ``jax.lax.all_gather(..., tiled=True)``: the axis's
                  blocks concatenated along a dimension, in coordinate order
  ``all_to_all``  ``jax.lax.all_to_all(..., split_axis=0, concat_axis=0,
                  tiled=False)``: chunk i of dimension 0 to coordinate i,
                  the chunks received stacked by the sender's coordinate

The sum, the gather and the all-to-all carry gradients (a sum's gradient
is the sum of the ranks' gradients; a gather's, its block of that sum;
an all-to-all's, the all-to-all back), so the moe layer's a2a dispatch
differentiates as the reference's does. The max does not.

The gradient convention of every sharded step: each rank's loss is its
share of the total, the shares summing to it over the whole mesh, and
every collective's backward is the exact adjoint of its forward (the
three above). A rank's gradient of a block is then its share of that
block's gradient, and the gradient of a parameter is the sum of its
ranks' gradients over the mesh axes its block is replicated on. Where
ranks along 'model' hold the same rows (Megatron's tensor parallelism),
each takes 1/m of those rows' loss: the row-parallel sum's backward then
adds the m shares of its output's gradient back into the whole one, and
a replicated activation's gradient is a partial whose sum over 'model'
is the whole. This is used in place of Megatron's f/g pair (an identity
with a summing backward, a sum with an identity backward) because it
needs no second form of any collective inside the model: the gathers
of ZeRO-3 (``gather_dims``) keep their one backward, the reduce-scatter,
whichever axes they run over, and the vocab-parallel embedding's sum
over 'model' (``models.layers.vocab_embed``) gives every rank the whole
gradient of its rows. The one
exception is the loss itself: ``sum_shares`` adds the ranks' shares into
the total every rank reports, and passes the gradient to each rank's
share unchanged.

``gather_dims`` rebuilds a whole tensor from a block (the inverse of
``runtime.sharding.local_block``), differentiably; ``make_mesh_from_ranks``
is the training CLI's mesh over every rank of the process group.

``received`` counts the bytes this rank receives in the collectives above
and their backwards, by kind (``all_reduce``, ``all_gather``,
``all_to_all``, each with ``.backward``), the most one call received, and
each distinct call (its kind, axis, type, shape and group size g, as the
reference's dry run lists ``"{op} {dtype}[{shape}] g={g}"``); it moves no
data of its own. It counts as a ring does: an all-reduce of n bytes over
g ranks receives 2(g − 1)/g · n (a reduce-scatter, then an all-gather:
NCCL's bus-bandwidth accounting), an all-gather of blocks of b bytes
(g − 1) · b, an all-to-all of n bytes (g − 1)/g · n. Inside a loop of
counted trips (``_counting.trips`` under a trip-counting analysis: the
training step's microbatches in the dry run) a call counts once for each
trip the body stands for. ``received.zero()`` sets every count to 0 and
``received.read()`` returns them, as the kernels' launch counters are
zeroed and read.

``meta_rank_mesh(shape, rank)`` is one rank's mesh on the ``meta``
device, over torch's ``fake`` process group, whose collectives move
nothing: the sharded steps run on it as on a placed mesh, computing only
shapes, and ``received`` counts what the rank would receive (the dry
run's per-rank programs). The ``fake`` backend serves ``meta`` only: a
mesh over it holds no other device, a mesh over a real backend no
``meta`` device, and every collective refuses a tensor off its mesh's
kind of device. ``sub_mesh`` is the mesh of some of a mesh's axes through
this rank (the compressed training step's pod, its ('data', 'model')
ranks), whose whole-mesh collectives span that slice only.

The backend is the caller's choice (``nccl`` on a pod, one rank a card;
``gloo`` for ranks on the host or several ranks sharing one card, where
it stages CUDA tensors through host memory itself); nothing here picks
another backend on a failure. ``run_ranks`` spawns the ranks of one mesh
on this host, each with one intra-op thread, and returns what each
rank's function returned.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import multiprocessing
import queue
import tempfile
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from .. import _counting

__all__ = ["make_production_mesh", "mesh_from_arg", "make_mesh", "make_mesh_from_ranks", "mesh_shape_from_ranks",
           "Mesh", "placed", "all_reduce", "sum_shares", "all_gather", "gather_dims", "spec_axes", "all_to_all",
           "run_ranks", "received", "AXES", "meta_rank_mesh", "sub_mesh"]

AXES = ("pod", "data", "model")


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
    axes = AXES[-len(dims):]
    return dict(zip(axes, dims))


class Mesh(dict):
    """A mesh placed over the process group: axis → size (read as a
    shapes-only mesh is), and for each axis ``groups[axis]``, the process
    group of the ranks that differ from this one only on that axis, and
    ``coords[axis]``, this rank's coordinate on it. ``device`` is this
    rank's device, ``backend`` the process group's; ``whole`` is the group
    of the mesh's every rank (None: the default group) and ``rank`` this
    rank's place in it, row-major."""

    def __init__(self, shape: dict, groups: dict, coords: dict, device: torch.device, backend: str, *,
                 whole=None, rank: int | None = None):
        super().__init__(shape)
        if (backend == "fake") != (device.type == "meta"):
            raise ValueError(f"Mesh: the fake backend serves the meta device only, not {backend!r} on {device}")
        self.groups = {ax: groups[ax] for ax in shape}
        self.coords = {ax: coords[ax] for ax in shape}
        self.device = device
        self.backend = backend
        self.whole = whole
        self.rank = dist.get_rank() if rank is None else rank


def placed(mesh) -> bool:
    """Whether ``mesh`` lives on a process group (``make_mesh``), as against
    a shapes-only mapping."""
    return isinstance(mesh, Mesh)


def make_mesh(shape: dict, *, device_type: str = "cuda") -> Mesh:
    """The mesh of ``shape`` (axis → size, the axes a suffix of ("pod",
    "data", "model")) over the initialised default process group, whose
    world size must be the mesh's size; ranks are laid out row-major (the
    last axis fastest), each on the card unless ``device_type`` says
    otherwise (``meta`` over the ``fake`` backend alone). Collective:
    every rank calls it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the process group first (torch.distributed.init_process_group)")
    names = tuple(shape)
    if not names or names != AXES[-len(names):]:
        raise ValueError(f"make_mesh: axes {names} must be a suffix of {AXES}")
    world = dist.get_world_size()
    if math.prod(shape.values()) != world:
        raise ValueError(f"make_mesh: mesh {dict(shape)} has {math.prod(shape.values())} ranks, the process "
                         f"group {world}")
    from torch.distributed.device_mesh import DeviceMesh

    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: device_type 'cuda' and no CUDA device on this rank")
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(device_type)
    dm = DeviceMesh(device_type, torch.arange(world).reshape(tuple(shape.values())), mesh_dim_names=names)
    return Mesh(shape, {ax: dm.get_group(ax) for ax in names}, dict(zip(names, dm.get_coordinate())), device,
                dist.get_backend())


def sub_mesh(mesh: Mesh, axes: tuple) -> Mesh:
    """The mesh of ``mesh``'s ``axes`` through this rank: the ranks that
    share its coordinates on the other axes, with their groups along
    ``axes`` (those of ``mesh``) and a whole group of their own, so that a
    collective over the whole mesh (``axis=None``) spans this slice alone.
    Collective: every rank of ``mesh`` calls it (each slice's group is
    made on every rank, in one order)."""
    axes = tuple(a for a in mesh if a in axes)
    rest = tuple(a for a in mesh if a not in axes)
    grid = torch.arange(math.prod(mesh.values())).reshape(tuple(mesh.values()))
    whole = None
    for at in itertools.product(*(range(mesh[a]) for a in rest)):
        index = tuple(at[rest.index(a)] if a in rest else slice(None) for a in mesh)
        ranks = grid[index].reshape(-1).tolist()
        group = dist.new_group(ranks)
        if all(mesh.coords[a] == c for a, c in zip(rest, at)):
            whole, rank = group, ranks.index(mesh.rank)
    return Mesh({a: mesh[a] for a in axes}, mesh.groups, mesh.coords, mesh.device, mesh.backend, whole=whole,
                rank=rank)


@contextlib.contextmanager
def meta_rank_mesh(shape: dict, rank: int = 0):
    """Rank ``rank``'s mesh of ``shape`` on the ``meta`` device, over a
    ``fake`` default process group made for it and destroyed after the
    block (module note). Refuses to run while a process group is
    initialised."""
    if dist.is_initialized():
        raise RuntimeError("meta_rank_mesh: a process group is initialised; a meta rank's mesh needs its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = math.prod(shape.values())
    if not 0 <= rank < world:
        raise ValueError(f"meta_rank_mesh: rank {rank} outside a mesh of {world}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield make_mesh(shape, device_type="meta")
    finally:
        dist.destroy_process_group()


def mesh_shape_from_ranks(world: int) -> dict:
    """The reference CLI's mesh over ``world`` devices
    (``repro.launch.train.make_mesh_from_devices``): 'model' is the first of
    16, 8, 4, 2, 1 that divides the world, 'data' the rest."""
    model = next(c for c in (16, 8, 4, 2, 1) if world % c == 0 and c <= world)
    return {"data": world // model, "model": model}


def make_mesh_from_ranks(*, device_type: str = "cuda") -> Mesh:
    """The ``mesh_shape_from_ranks`` mesh over every rank of the initialised
    process group. Collective: every rank calls it."""
    return make_mesh(mesh_shape_from_ranks(dist.get_world_size()), device_type=device_type)


# -- bytes received ---------------------------------------------------------------

class Received:
    """Bytes this rank received in the collectives of this module since
    ``zero()``: ``by_kind``, ``largest``, the most one call received, and
    ``calls``, each distinct call's description → [count, bytes a call]."""

    def __init__(self):
        self.zero()

    def zero(self) -> None:
        self.by_kind: dict = {}
        self.largest = 0
        self.calls: dict = {}

    def add(self, kind: str, nbytes: int, axis, x: torch.Tensor, g: int) -> None:
        """One call of ``kind`` over ``axis`` (None: the whole mesh) and
        ``g`` ranks that received ``nbytes``, ``x`` its buffer; it counts
        once for each trip the running body stands for."""
        k = _counting.trip_scale()
        self.by_kind[kind] = self.by_kind.get(kind, 0) + k * nbytes
        self.largest = max(self.largest, nbytes)
        desc = (f"{kind} {axis or 'mesh'} {str(x.dtype).removeprefix('torch.')}"
                f"[{','.join(str(n) for n in x.shape)}] g={g}")
        rec = self.calls.setdefault(desc, [0, nbytes])
        rec[0] += k

    def top(self, n: int = 10) -> list:
        """The ``n`` calls that received most, as the reference's dry run
        lists them: "{MiB} {kind} {axis} {dtype}[{shape}] g={g}", with
        their count."""
        calls = sorted(self.calls.items(), key=lambda kv: (-kv[1][1], kv[0]))[:n]
        return [f"{b / 2**20:.1f}MiB {desc} x{c}" for desc, (c, b) in calls]

    def read(self) -> dict:
        """{"total", "by_kind", "largest", "top"}, copies."""
        return {"total": sum(self.by_kind.values()), "by_kind": dict(self.by_kind), "largest": self.largest,
                "top": self.top()}


received = Received()


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _count_reduce(x: torch.Tensor, g: int, kind: str, axis) -> None:
    received.add(kind, 2 * (g - 1) * _nbytes(x) // g, axis, x, g)


# -- collectives along one axis ---------------------------------------------------

def _group(mesh: Mesh, axis):
    return mesh.whole if axis is None else mesh.groups[axis]


def _size(mesh: Mesh, axis) -> int:
    return math.prod(mesh.values()) if axis is None else mesh[axis]


def _on_mesh(x: torch.Tensor, mesh: Mesh, what: str) -> None:
    """Refuse a tensor off the mesh's kind of device: a ``meta`` one on a
    real backend's mesh, any other on the ``fake`` backend's."""
    if (x.device.type == "meta") != (mesh.device.type == "meta"):
        raise ValueError(f"{what}: a tensor on {x.device} on a mesh of {mesh.device} ({mesh.backend})")


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, axis):
        ctx.group, ctx.n, ctx.axis = group, n, axis
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        _count_reduce(out, n, "all_reduce", axis)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        _count_reduce(g, ctx.n, "all_reduce.backward", ctx.axis)
        return g, None, None, None


def all_reduce(x: torch.Tensor, axis, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """The sum (or max) of ``x`` over the ranks along ``axis`` (over the
    whole mesh with None), on every one of them; ``x`` is left as it is."""
    n = _size(mesh, axis)
    if n == 1:
        return x
    _on_mesh(x, mesh, "all_reduce")
    if op == "sum":
        return _AllReduceSum.apply(x, _group(mesh, axis), n, axis)
    if op != "max":
        raise ValueError(f"all_reduce: op {op!r} is 'sum' or 'max'")
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_group(mesh, axis))
    _count_reduce(out, n, "all_reduce", axis)
    return out


class _SumShares(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        _count_reduce(out, n, "all_reduce", None)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_shares(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the ranks' shares ``x`` over the whole mesh, on every rank;
    its gradient reaches each rank's share as it is (Megatron's g): a loss
    whose ranks' shares sum to the total reports the total, and each rank
    differentiates its share."""
    n = _size(mesh, None)
    if n == 1:
        return x
    _on_mesh(x, mesh, "sum_shares")
    return _SumShares.apply(x, mesh.whole, n)


def _gather(x: torch.Tensor, group, n: int, dim: int, axis) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    received.add("all_gather", (n - 1) * _nbytes(x), axis, x, n)
    return torch.cat(parts, dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index, dim, axis):
        ctx.group, ctx.n, ctx.index, ctx.dim, ctx.block, ctx.axis = group, n, index, dim, x.shape[dim], axis
        return _gather(x, group, n, dim, axis)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        _count_reduce(g, ctx.n, "all_gather.backward", ctx.axis)
        # a copy of the block, so that the whole sum is freed here
        return g.narrow(ctx.dim, ctx.index * ctx.block, ctx.block).clone(), None, None, None, None, None


def all_gather(x: torch.Tensor, axis, mesh: Mesh, dim: int) -> torch.Tensor:
    """The ranks' blocks along ``axis`` concatenated on ``dim`` in
    coordinate order (``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``);
    with ``axis`` None every rank's block, in rank order (the mesh's
    row-major order)."""
    n = _size(mesh, axis)
    if n == 1:
        return x
    _on_mesh(x, mesh, "all_gather")
    index = mesh.rank if axis is None else mesh.coords[axis]
    return _AllGather.apply(x, _group(mesh, axis), n, index, dim % x.dim(), axis)


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry: a name, a tuple of names, or None."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def gather_dims(x: torch.Tensor, spec: tuple, mesh: Mesh, axes=None) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's block under ``spec``
    (``runtime.sharding.local_block``'s inverse): each dimension sharded
    over mesh axes gathered over them, the last axis of a tuple first, as
    the block index reads them (the first axis major). With ``axes``, only
    the dimensions sharded over those axes alone (ZeRO-3's 'data'). The
    gradient comes back through the gathers: the block of the sum over the
    axes gathered."""
    for dim, entry in enumerate(spec):
        names = spec_axes(entry)
        if not names or (axes is not None and not set(names) <= set(axes)):
            continue
        for ax in reversed(names):
            x = all_gather(x, ax, mesh, dim=dim)
    return x


def _exchange(x: torch.Tensor, group, n: int, kind: str, axis) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    received.add(kind, (n - 1) * _nbytes(x) // n, axis, x, n)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, axis):
        ctx.group, ctx.n, ctx.axis = group, n, axis
        return _exchange(x, group, n, "all_to_all", axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.n, "all_to_all.backward", ctx.axis), None, None, None


def all_to_all(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    """x's dimension 0 (a multiple of the axis's size) cut into equal
    chunks, chunk i sent to coordinate i; the result holds the chunks
    received, in the senders' coordinate order."""
    n = mesh[axis]
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dimension 0 of {tuple(x.shape)} does not divide over {axis!r} ({n})")
    if n == 1:
        return x
    _on_mesh(x, mesh, "all_to_all")
    return _AllToAll.apply(x, mesh.groups[axis], n, axis)


# -- ranks of one mesh on this host ---------------------------------------------

def _rank_main(rank: int, shape: dict, backend: str, device_type: str, init: str, fn, args, results) -> None:
    try:
        torch.set_num_threads(1)
        if device_type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"rank {rank}: device_type 'cuda' and no CUDA device")
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init, world_size=math.prod(shape.values()), rank=rank)
        try:
            out = fn(make_mesh(shape, device_type=device_type), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, shape: dict, *, backend: str, device_type: str = "cuda", args: tuple = (),
              timeout: float = 600.0) -> list:
    """``fn(mesh, *args)`` on each rank of a mesh of ``shape``, one spawned
    process a rank on this host (``fn`` importable, its result picklable),
    the ranks meeting through a file in a fresh temporary directory.
    Returns the results in rank order; raises with the first failing
    rank's traceback, or when ``timeout`` seconds pass, after ending every
    process it started."""
    world = math.prod(shape.values())
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        init = (Path(tmp) / "rendezvous").as_uri()
        procs = [ctx.Process(target=_rank_main, args=(r, dict(shape), backend, device_type, init, fn, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, failure = {}, None
        try:
            while len(got) < world and failure is None:
                rank, ok, out = results.get(timeout=timeout)
                if ok:
                    got[rank] = out
                else:
                    failure = f"rank {rank} failed:\n{out}"
        except queue.Empty:
            failure = f"run_ranks: {world - len(got)} of {world} ranks gave no result in {timeout} s"
        finally:
            for p in procs:
                p.join(timeout=5 if failure else 60)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    if failure:
        raise RuntimeError(failure)
    return [got[r] for r in range(world)]
