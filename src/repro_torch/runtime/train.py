"""Train and prefill steps (``repro.runtime.train``), on one device or on
each rank of a mesh placed over a process group.

``build_train_step(lm, tcfg)`` returns ``train_step(opt, batch)``,
which updates ``lm``'s parameters and the optimizer state ``opt`` in
place and returns ``{"loss", "grad_norm", "lr"}``: the gradients of
``lm.loss`` (microbatches accumulated in float32 and averaged, as the
reference's scan does), clipped by global norm, a linear-warmup cosine
learning rate at the step before the update, then AdamW or its int8
variant. ``TrainConfig.compress_pod_grads`` does nothing without a pod
axis, as in the reference, which compresses only across more than one
pod.

With a mesh placed over a process group (``launch.mesh.make_mesh``;
every rank calls the step's constructor with the whole ``lm``), every
family's steps (dense, vlm, moe, ssm, hybrid, encdec) run on each rank's
blocks, as the reference's run under XLA's partitioner with the TP ×
ZeRO-3 rules of ``runtime.sharding``.
``place_`` replaces ``lm``'s parameters by this rank's blocks
(``param_specs``: training ZeRO-shards, serving as ``needs_zero3``
decides) and sets its ``placement``; the model then runs the sharded
attention, MLA, RG-LRU, Mamba-2, MLP and experts on the rank's rows
(``shard_batch``: the global
batch over ('pod', 'data'), which it must divide; every key of it, the
image or audio embeddings too). The train step has one
body (``_step``) on one device and under a mesh; under a mesh it:

* takes the reference's microbatches, rows [i·B/n, (i+1)·B/n) of the
  global batch: the rows are gathered over the batch axes (tokens and
  labels) and each microbatch cut again, its gradients accumulated in
  float32;
* gives each rank its share of every block's gradient (the convention of
  ``launch.mesh``) and sums it over the axes the block is replicated on,
  bucketed by axes and type;
* clips by the global norm: each leaf's squares summed over the axes that
  shard it, counted once over those that replicate it;
* runs AdamW elementwise on the blocks, and adamw8 on the rank's blocks
  of the whole state (``opt8_specs``), its codes in the whole leaf's
  blocks. Where that spec dropped an axis (the block count does not
  divide over it), the moments are whole along the last dimension while
  the parameter is cut: the leaf's gradient and parameter are gathered
  along it, updated whole, and the parameter's block taken back.

``init_opt_state`` of a placed model allocates the rank's blocks of the
zero state.

``compress_pod_grads`` with a pod axis runs the reference's ``per_pod``
body (``repro.runtime.train``, whose own path CHECK-fails in XLA's
partitioner: ROADMAP C11): the model runs on the pod's ('data', 'model')
sub-mesh (``launch.mesh.sub_mesh``), so its loss is the mean of the pod's
rows (the count, the moe aux, T, the capacity and the gather dispatch's
slots the pod's), and the microbatches are the pod's rows cut again
(rows [p·B/P + i·B/(P·n), …)). Its gradient blocks are summed in float
over the pod's replica axes, then each leaf is synced over 'pod' in int8
(``_int8_pod_sum``): one per-tensor scale max(amax, 1e-12)/127 from the
amax of the reference's whole leaf (a family's layers stacked in one),
codes clamp(round(x/scale), −127, 127), the codes
summed as int32 and the scales summed over 'pod', the gradient
summed·(scale_sum/n)/n in the leaf's type. The loss is averaged over
'pod'; the norm, the schedule and the update follow as without
compression. The int32 sum moves 4 bytes an element over 'pod', as the
reference's HLO would.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .._counting import trips
from ..launch.mesh import all_reduce, gather_dims, placed, sub_mesh
from ..models import LM
from ..models.lm import Placement
from ..optim import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm, linear_warmup_cosine
from ..optim.adamw import stack_position
from ..optim.adamw8 import adamw8_init, adamw8_update
from .sharding import (batch_axes, batch_specs, block_shape, local_block, needs_zero3, opt_state_specs,
                       param_specs, spec_axes)

__all__ = ["TrainConfig", "build_train_step", "build_prefill_step", "abstract_train_state", "init_opt_state",
           "place_", "shard_batch"]


@dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0
    microbatches: int = 1
    compress_pod_grads: bool = False   # int8 cross-pod gradient sum (a no-op without a pod axis)
    optimizer: str = "adamw"           # 'adamw' | 'adamw8' (int8 moments)
    adamw: AdamWConfig = AdamWConfig()


def _init_fn(optimizer: str):
    if optimizer not in ("adamw", "adamw8"):
        raise ValueError(f"optimizer must be 'adamw' or 'adamw8', got {optimizer!r}")
    return adamw8_init if optimizer == "adamw8" else adamw_init


def init_opt_state(lm: LM, optimizer: str = "adamw") -> dict:
    """Zero optimizer state for ``lm``'s parameters, on their device; for a
    placed model (``place_``) this rank's blocks of the whole state."""
    if lm.placement is None:
        return _init_fn(optimizer)(dict(lm.named_parameters()))
    mesh = lm.placement.mesh
    _, whole = abstract_train_state(lm, optimizer)
    specs = opt_state_specs(mesh, whole, lm.placement.specs, optimizer)

    def zeros(t, spec):
        if isinstance(t, dict):
            return {k: zeros(v, spec[k]) for k, v in t.items()}
        return torch.zeros(block_shape(t.shape, spec, mesh), dtype=t.dtype, device=lm.device)

    return zeros(whole, specs)


def abstract_train_state(lm: LM, optimizer: str = "adamw"):
    """(parameters, optimizer state) of ``lm``'s configuration as tensors on
    the ``meta`` device: shapes and types, no storage (the reference's
    ``seed`` argument drops out: nothing is drawn). The whole state also
    for a placed model."""
    meta = LM(lm.cfg, device="meta")
    params = dict(meta.named_parameters())
    return params, _init_fn(optimizer)(params)


def _on(device, batch: dict) -> dict:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v, device=device)
            for k, v in batch.items()}


def _grad(p: torch.Tensor) -> torch.Tensor:
    """``p``'s gradient; zeros where the loss does not reach it (the sigmoid
    router's bias only picks experts), as ``jax.grad`` gives them, so that
    clipping and the update (its weight decay) treat it as the reference does."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


# -- under a mesh -------------------------------------------------------------------

def _check_mesh(lm: LM, mesh, what: str) -> None:
    """What a step under ``mesh`` refuses: a shapes-only mesh, a model that
    holds blocks already or lies on another device."""
    if not placed(mesh):
        raise ValueError(f"{what}: the mesh must be placed over a process group (launch.mesh.make_mesh)")
    if lm.placement is not None:
        raise ValueError(f"{what}: the model holds a rank's blocks already; pass the whole model")
    if lm.device != mesh.device:
        raise ValueError(f"{what}: the model lies on {lm.device}, this rank's device is {mesh.device}")


def place_(lm: LM, specs: dict, mesh, *, trainable: bool) -> LM:
    """Replace every parameter of the whole model ``lm`` by this rank's block
    under ``specs`` (a cut one in storage of its own, a whole one kept), as
    trainable leaves or not, and set ``lm.placement``; returns ``lm``."""
    for name, p in list(lm.named_parameters()):
        spec = specs[name]
        t = p.detach()
        if any(e is not None for e in spec):
            t = local_block(t, spec, mesh).clone()
        owner, _, leaf = name.rpartition(".")
        setattr(lm.get_submodule(owner), leaf, nn.Parameter(t, requires_grad=trainable))
    lm.placement = Placement(mesh, dict(specs), math.prod(mesh[a] for a in batch_axes(mesh)))
    return lm


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch (name → array or tensor, the batch
    leading) under ``runtime.sharding.batch_specs``, on the rank's device.
    Refuses a batch that does not split over every batch axis (pod × data):
    a sharded step reads the rows as a split of the global batch."""
    n = math.prod(mesh[a] for a in batch_axes(mesh))
    out = {}
    for k, v in _on(mesh.device, batch).items():
        if v.shape[0] % n:
            raise ValueError(f"shard_batch: {k}'s {v.shape[0]} rows do not split over the batch axes "
                             f"{batch_axes(mesh)} ({n} ranks)")
        out[k] = local_block(v, batch_specs(mesh, {k: v})[k], mesh)
    return out


def _microbatches(batch: dict, n: int, mesh):
    """This rank's rows of the i-th of the global batch's ``n`` microbatches
    (rows [i·B/n, (i+1)·B/n), the reference's reshape), from its rows of the
    global batch: gathered whole over the batch axes and cut again (on a
    pod's sub-mesh, the pod's rows)."""
    axes = batch_axes(mesh)
    shards = math.prod(mesh[a] for a in axes)
    whole = {k: gather_dims(v, (axes or None,) + (None,) * (v.dim() - 1), mesh) for k, v in batch.items()}
    B = next(iter(whole.values())).shape[0]
    if B % (n * shards):
        raise ValueError(f"a global batch of {B} does not split into {n} microbatches over {shards} batch ranks")
    m = B // n
    return lambda i: shard_batch({k: v[i * m:(i + 1) * m] for k, v in whole.items()}, mesh)


def _layout(mesh, pspecs: dict, whole: dict, ospecs: dict, optimizer: str) -> dict:
    """Per parameter: the mesh axes that shard it and those it is replicated
    on (sizes > 1 only), and for adamw8 the last dimension's spec entry where
    the codes' spec dropped it (moments whole along it)."""
    live = [a for a in mesh if mesh[a] > 1]
    out = {}
    for name, spec in pspecs.items():
        used = {a for e in spec for a in spec_axes(e)}
        drop = None
        if optimizer == "adamw8" and spec and spec[-1] is not None and ospecs["m"][name]["scale"][-1] is None:
            drop = spec[-1]
        out[name] = dict(shard=tuple(a for a in live if a in used), rep=tuple(a for a in live if a not in used),
                         drop=drop, last=whole[name].shape[-1] if whole[name].dim() else 1)
    return out


@torch.no_grad()
def _sum_replicas(grads: dict, layout: dict, mesh) -> None:
    """Each gradient block summed over the axes its block is replicated on,
    in place: one all-reduce an axis for each (axes, type) bucket."""
    buckets: dict = {}
    for name, g in grads.items():
        if layout[name]["rep"]:
            buckets.setdefault((layout[name]["rep"], g.dtype), []).append(name)
    for (axes, _), names in buckets.items():
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        for ax in axes:
            flat = all_reduce(flat, ax, mesh)
        for n, piece in zip(names, torch.split(flat, [grads[n].numel() for n in names])):
            grads[n] = piece.view(grads[n].shape)


@torch.no_grad()
def _global_norm(grads: dict, layout: dict, mesh) -> torch.Tensor:
    """‖g‖ of the whole gradient from the blocks: each leaf's Σ g² summed
    over the axes that shard it, once over the axes that replicate it."""
    by_axes: dict = {}
    for name, g in grads.items():
        s = torch.sum(torch.square(g.float()))
        key = layout[name]["shard"]
        by_axes[key] = by_axes[key] + s if key in by_axes else s
    total = None
    for axes, s in by_axes.items():
        for ax in axes:
            s = all_reduce(s, ax, mesh)
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def _int8_pod_sum(grads: dict, layout: dict, mesh) -> dict:
    """Each gradient (a pod's, whole over the pod's replica axes) replaced,
    in place, by the reference's int8 sum over 'pod'
    (``repro.runtime.train``'s ``sync``): a per-tensor scale from the amax
    of the reference's whole leaf (its blocks' max over the axes that shard
    it, and over the layers of a stacked leaf: ``adamw.stack_position``),
    the int8 codes of ``x.float()``, summed as int32 over 'pod' with the
    scales, then summed·(scale_sum/n)/n in the gradient's type. Returns
    each leaf's ('/'-joined path) (this pod's scale, the pods' scale sum),
    float32 0-d tensors."""
    leaves: dict = {}
    for name in grads:
        pos = stack_position(name)
        leaves.setdefault(pos[0] if pos else (name,), []).append(name)
    by_axes: dict = {}
    for leaf, names in leaves.items():
        by_axes.setdefault(layout[names[0]]["shard"], []).append(leaf)
    amax: dict = {}
    for axes, group in by_axes.items():
        m = torch.stack([torch.stack([grads[k].float().abs().amax() for k in leaves[leaf]]).amax()
                         for leaf in group])
        for ax in axes:
            m = all_reduce(m, ax, mesh, op="max")
        amax.update(zip(group, m))
    order = list(leaves)
    # divisors on the device: a host scalar divisor is a reciprocal product on the card (ROADMAP C2)
    c127, n_t = (torch.full((), v, dtype=torch.float32, device=amax[order[0]].device)
                 for v in (127.0, mesh["pod"]))
    scales = torch.clamp(torch.stack([amax[leaf] for leaf in order]), min=1e-12) / c127
    sums = all_reduce(scales, "pod", mesh)
    means = sums / n_t
    for leaf, scale, mean in zip(order, scales, means):
        for name in leaves[leaf]:
            g = grads[name]
            # the int8 codes, held as int32 for the sum (in place: a leaf's float copies are its largest buffers)
            q = g.float().div_(scale).round_().clamp_(-127, 127).to(torch.int32)
            summed = all_reduce(q, "pod", mesh)
            del q
            grads[name] = summed.float().mul_(mean).div_(n_t).to(g.dtype)
    return {"/".join(leaf): (scale, total) for leaf, scale, total in zip(order, scales, sums)}


@torch.no_grad()
def _adamw8_blocks(grads: dict, opt: dict, params: dict, lr, cfg: AdamWConfig, layout: dict, mesh) -> None:
    """adamw8 on the rank's blocks of the whole state; a leaf whose moments
    are whole along its last dimension (``layout``'s ``drop``) is updated
    whole along it and its block taken back."""
    full_g, full_p, cut = dict(grads), dict(params), {}
    for name, lay in layout.items():
        if lay["drop"] is None:
            continue
        spec = (None,) * (params[name].dim() - 1) + (lay["drop"],)
        full_g[name] = gather_dims(grads[name], spec, mesh)
        full_p[name] = gather_dims(params[name].detach(), spec, mesh)
        cut[name] = spec
    adamw8_update(full_g, opt, full_p, lr, cfg, last_dims={n: lay["last"] for n, lay in layout.items()})
    for name, spec in cut.items():
        params[name].copy_(local_block(full_p[name], spec, mesh))


def _step(lm: LM, params: dict, tcfg: TrainConfig, microbatch, reduce, norm, update):
    """The train step's one body: the gradients of ``lm.loss`` (over
    ``tcfg.microbatches`` microbatches, ``microbatch(batch, n)`` giving the
    i-th, accumulated in float32), ``reduce(grads, loss)``'d in place (it
    returns the loss the step reports), clipped by the norm ``norm`` gives
    (None: ``clip_by_global_norm``'s own), the learning rate, then
    ``update(grads, opt, lr)``."""

    def backward(batch) -> torch.Tensor:
        for p in params.values():
            p.grad = None
        loss, _ = lm.loss(batch)
        loss.backward()
        return loss.detach()

    def grads_of(batch):
        n = tcfg.microbatches
        if n <= 1:
            loss = backward(batch)
            return {k: _grad(p) for k, p in params.items()}, loss
        mb = microbatch(batch, n)
        gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
        lsum = torch.zeros((), dtype=torch.float32, device=lm.device)
        for i in trips(n):      # one counted trip, scaled by n, under the dry run's analysis
            lsum += backward(mb(i))
            for k, p in params.items():
                if p.grad is not None:
                    gsum[k] += p.grad.float()
                p.grad = None
        inv = 1.0 / n
        return {k: g.mul_(inv) for k, g in gsum.items()}, lsum * inv

    def train_step(opt: dict, batch: dict) -> dict:
        grads, loss = grads_of(_on(lm.device, batch))
        loss = reduce(grads, loss)
        grads, gnorm = clip_by_global_norm(grads, tcfg.max_grad_norm, norm=norm(grads))
        lr = linear_warmup_cosine(opt["step"], tcfg.warmup_steps, tcfg.total_steps, tcfg.peak_lr)
        update(grads, opt, lr)
        for p in params.values():
            p.grad = None
        return {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def _reshaped(batch: dict, n: int):
    """The i-th of the batch's ``n`` microbatches, rows [i·B/n, (i+1)·B/n)."""
    if any(v.shape[0] % n for v in batch.values()):
        raise ValueError(f"batch of {next(iter(batch.values())).shape[0]} does not split into {n} microbatches")
    return lambda i: {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i] for k, v in batch.items()}


def build_train_step(lm: LM, tcfg: TrainConfig = TrainConfig(), *, mesh=None):
    """``train_step(opt, batch) → {"loss", "grad_norm", "lr"}`` for ``lm``
    on its device; turns ``lm``'s gradients on.

    With a mesh placed over a process group (every rank passes the whole
    ``lm``, on its device): (train_step, (params_sh, opt_sh)). ``lm``'s
    parameters become this rank's blocks under ``params_sh`` (``place_``)
    and ``opt_sh`` are the specs of the optimizer state, whose blocks
    ``init_opt_state(lm, tcfg.optimizer)`` then allocates; ``batch`` is this
    rank's rows (``shard_batch``). Every rank gets the global loss, norm and
    learning rate."""
    _init_fn(tcfg.optimizer)
    cfg = tcfg.adamw
    if mesh is None:
        lm.requires_grad_(True)
        params = dict(lm.named_parameters())
        update = adamw8_update if tcfg.optimizer == "adamw8" else adamw_update
        return _step(lm, params, tcfg, _reshaped, lambda g, loss: loss, lambda g: None,
                     lambda g, opt, lr: update(g, opt, params, lr, cfg))
    _check_mesh(lm, mesh, "build_train_step")
    whole, opt_whole = abstract_train_state(lm, tcfg.optimizer)
    pspecs = param_specs(mesh, whole, zero3=True)
    ospecs = opt_state_specs(mesh, opt_whole, pspecs, tcfg.optimizer)
    layout = _layout(mesh, pspecs, whole, ospecs, tcfg.optimizer)
    compress = tcfg.compress_pod_grads and mesh.get("pod", 1) > 1
    # under compression the model sees its pod alone, as the reference's per_pod body
    run = sub_mesh(mesh, ("data", "model")) if compress else mesh
    place_(lm, pspecs, run, trainable=True)
    params = dict(lm.named_parameters())
    if tcfg.optimizer == "adamw8":
        def update(g, opt, lr):
            _adamw8_blocks(g, opt, params, lr, cfg, layout, mesh)
    else:
        def update(g, opt, lr):
            adamw_update(g, opt, params, lr, cfg)
    if compress:
        pod_layout = _layout(run, pspecs, whole, ospecs, tcfg.optimizer)

        def reduce(g, loss):
            _sum_replicas(g, pod_layout, run)
            _int8_pod_sum(g, layout, mesh)
            return all_reduce(loss, "pod", mesh) / mesh["pod"]
    else:
        def reduce(g, loss):
            _sum_replicas(g, layout, mesh)
            return loss
    step = _step(lm, params, tcfg, lambda batch, n: _microbatches(batch, n, run), reduce,
                 lambda g: _global_norm(g, layout, mesh), update)
    return step, (pspecs, ospecs)


def build_prefill_step(lm: LM, *, mesh=None):
    """Forward-only step (inference prefill): batch → the final
    position's logits (B, 1, V); the (B, S, V) tensor never exists.

    With a mesh placed over a process group: (prefill_step, params_sh).
    ``lm``'s parameters become this rank's blocks under serving's specs
    (``param_specs(..., serve=True)``: ZeRO-sharded over 'data' only where
    ``needs_zero3`` finds the TP-only blocks too large), and the step maps
    this rank's rows of the batch (``shard_batch``) to their logits, whole
    along V: the tables are used where they stand (the rank's vocab rows,
    its block of the logits gathered over 'model' at the end)."""
    if mesh is not None:
        _check_mesh(lm, mesh, "build_prefill_step")
        pspecs = param_specs(mesh, lm, needs_zero3(mesh, lm, serve=True))
        place_(lm, pspecs, mesh, trainable=False)

    def prefill_step(batch: dict) -> torch.Tensor:
        batch = _on(lm.device, batch)
        logits, _ = lm.forward(batch["tokens"], image_embeds=batch.get("image_embeds"),
                               audio_embeds=batch.get("audio_embeds"), last_only=True)
        return logits

    return prefill_step if mesh is None else (prefill_step, pspecs)
