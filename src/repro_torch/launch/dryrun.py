"""Dry run on the ``meta`` device: every (architecture × input shape ×
mesh) cell's step run once with no storage, its work counted, and the
roofline terms against one H100 (the port of ``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape decode_32k --mesh 1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1 --out artifacts/dryrun

Needs no card. The reference lowers and compiles each cell for a
forced-host mesh and reads XLA's analyses; here the step the port would
run (``runtime.train.build_train_step``, ``build_prefill_step``,
``runtime.serve.build_serve_step``) runs once on a ``meta`` ``LM``, fed
``configs.shapes.input_specs`` and ``runtime.serve.abstract_cache``,
under ``launch.op_analysis.OpAnalysis``: aten FLOPs and bytes, the
attention kernels' charged work (their ``meta`` route launches nothing)
and the live-storage high-water mark. Per cell the JSON artifact keeps
every key of the reference's record, with

  params                  ``count_params`` (total, and active: routed
                          experts discounted to top_k / num_experts)
  model_flops_per_device  6·N·D for training, 2·N·D for inference
  memory.argument_bytes   parameters, optimizer state, batch and cache a
                          device holds under ``runtime.sharding``'s rules
  memory.temp_bytes       the high-water mark of storage the step creates
  roofline_terms          against ``grid.capacity``'s H100 peaks
                          (989 TFLOP/s bf16, 3.35 TB/s, NVLink 450 GB/s
                          received), collective_s 0 on one device

A decode cell is one ``decode_step`` at the last position, max_len − 1,
of a max_len cache.

On a mesh of more than one device the record is rank 0's program: the
cell's sharded step (``build_train_step(lm, tcfg, mesh=...)``,
``build_prefill_step(lm, mesh=...)`` or ``build_serve_step(lm, B,
max_len, mesh=...)``) built on a whole ``meta`` ``LM`` over
``launch.mesh.meta_rank_mesh`` (torch's ``fake`` process group, whose
collectives move nothing) and run once on the rank's blocks and rows
(``shard_batch``) under ``OpAnalysis(trips=True)``. Its FLOPs, bytes and
high-water mark are the rank's, and ``collectives`` what
``launch.mesh.received`` counted: the bytes the rank receives (ring
accounting, each microbatch's calls counted once a trip), by kind and
count, and the largest calls. A collective's buffers also count as HBM
bytes, as the reference adds a collective's operands and result to its
``hbm_bytes``. ``collective_s`` is those bytes over one H100's NVLink 4
receive rate (``grid.capacity.NVLINK_RX_BW``); a mesh wider than one
NVLink domain of 8 cards crosses slower links, so there the term is a
lower bound (``collective_link``). A decode cell's
``collectives.parameter_gathers`` lists the calls that gather a block of
a parameter (``parameter_gathers``), each with its count and bytes: a
decode step moves only activations but where the gather dispatch
gathers a held expert block (ROADMAP Next 3). One rank stands for all: the rules cut
only dimensions that divide, so every rank's blocks have the same shapes.
``memory.argument_bytes`` is the rules' count (``runtime.sharding``),
and ``memory.held_groups`` the bytes of the blocks the rank holds, by
group: equal for every kind (checked; a decode step's caches are cut on
their batch dimension where the rules would cut a stacked layer axis as
long as the batch, ROADMAP C13, the same bytes). ``--moe-impl
a2a|auto`` and ``--compress-pod-grads`` (the pod axis's int8 gradient
sum) run on that mesh. The artifacts load through
``grid.capacity_from_roofline`` as the reference's do.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import sys
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, Shape, cells, input_specs
from repro_torch.grid.capacity import HBM_BW, NVLINK_RX_BW, PEAK_FLOPS
from repro_torch.launch.mesh import mesh_from_arg, meta_rank_mesh, received, spec_axes
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.models import LM, moe
from repro_torch.runtime import sharding as shlib
from repro_torch.runtime.serve import abstract_cache, build_serve_step
from repro_torch.runtime.train import TrainConfig, build_prefill_step, build_train_step, init_opt_state, shard_batch

__all__ = ["run_cell", "count_params", "auto_microbatches", "analyze_step", "analyze_rank_step", "rank_step",
           "step_arguments", "make_step", "argument_bytes", "parameter_gathers", "DEVICE_BYTES", "COLLECTIVE_LINK"]

# One H100's memory, the data sheet's 80 GB: a cell fits where its
# argument and temporary bytes a device stay within it.
DEVICE_BYTES = 80e9
COLLECTIVE_LINK = ("NVLink 4, 450 GB/s received per H100 (grid.capacity.NVLINK_RX_BW); on a mesh wider than one "
                   "NVLink domain of 8 cards collective_s is a lower bound")

# activation budget steering the automatic microbatch count
_CARRY_BUDGET = 4 * 2**30  # per-device live residual-carry bytes


def auto_microbatches(cfg, sh, mesh: dict) -> int:
    """Grad-accumulation factor so the layers' residual carries
    (L × B/dev × S × d × 2B) stay under the per-device budget."""
    data = mesh.get("data", 1) * mesh.get("pod", 1)
    S = sh.seq_len if cfg.family != "encdec" else 448
    per_dev_B = max(sh.global_batch // data, 1)
    layers = cfg.num_layers + cfg.num_encoder_layers
    carry = layers * per_dev_B * S * cfg.d_model * 2
    mb = 1
    while (carry / mb > _CARRY_BUDGET
           and mb * 2 <= sh.global_batch
           and (sh.global_batch // (mb * 2)) % max(data, 1) == 0):
        mb *= 2
    return mb


def count_params(params, cfg) -> tuple[float, float]:
    """(total, active) parameter counts of an ``LM`` or a name → tensor
    mapping; active discounts the routed experts (and, as the reference's
    count does, every expert matrix under ``moe``) to top_k of
    num_experts."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    total = active = 0.0
    for name, p in params.items():
        n = float(p.numel())
        total += n
        keys = name.split(".")
        if cfg.num_experts and any(k in ("w_gate", "w_up", "w_down") for k in keys) and "moe" in keys:
            active += n * cfg.top_k / cfg.num_experts
        else:
            active += n
    return total, active


def _shape_batch(cfg, sh: Shape, labels: bool = True) -> dict:
    """The step's batch as ``meta`` tensors: ``input_specs`` of a named
    shape; for a reduced shape (``--reduced``) the same rebuilt at its
    shrunken dims (encdec with a 32-token decoder)."""
    if sh.name in SHAPES and sh.seq_len == SHAPES[sh.name].seq_len:
        spec = input_specs(cfg, sh.name)
    else:
        B, S, d, f = sh.global_batch, sh.seq_len, cfg.d_model, cfg.cdtype
        meta = lambda *s, dtype=torch.int32: torch.empty(s, dtype=dtype, device="meta")  # noqa: E731
        if cfg.family == "encdec":
            T = 32
            spec = {"tokens": meta(B, T), "labels": meta(B, T), "audio_embeds": meta(B, S, d, dtype=f)}
        else:
            spec = {"tokens": meta(B, S), "labels": meta(B, S)}
            if cfg.family == "vlm":
                spec["image_embeds"] = meta(B, cfg.num_image_tokens, d, dtype=f)
    if not labels:
        spec = {k: v for k, v in spec.items() if k != "labels"}
    return spec


def step_arguments(lm: LM, sh: Shape, *, optimizer: str = "adamw") -> dict:
    """The step's arguments for a ``meta`` ``lm``: ``params`` and, by kind,
    ``opt`` and ``batch`` (train), ``batch`` (prefill), or ``cache`` and
    ``batch`` = the (B, 1) int32 tokens (decode)."""
    args = {"params": dict(lm.named_parameters())}
    if sh.kind == "train":
        args["opt"] = init_opt_state(lm, optimizer)
        args["batch"] = _shape_batch(lm.cfg, sh)
    elif sh.kind == "prefill":
        args["batch"] = _shape_batch(lm.cfg, sh, labels=False)
    else:
        args["cache"] = abstract_cache(lm, sh.global_batch, sh.seq_len)
        args["batch"] = {"tokens": torch.empty((sh.global_batch, 1), dtype=torch.int32, device="meta")}
    return args


def make_step(lm: LM, sh: Shape, *, microbatches: int = 1, optimizer: str = "adamw"):
    """``step(args) → outputs`` of the cell's kind on ``lm``'s device: the
    training step (AdamW or adamw8, ``microbatches``), the prefill step
    (the last position's logits) or one serve step at position
    max_len − 1 (logits, cache)."""
    if sh.kind == "train":
        train = build_train_step(lm, TrainConfig(microbatches=microbatches, optimizer=optimizer))
        return lambda args: train(args["opt"], args["batch"])
    if sh.kind == "prefill":
        prefill = build_prefill_step(lm)
        return lambda args: prefill(args["batch"])
    serve, _ = build_serve_step(lm, sh.global_batch, sh.seq_len)
    return lambda args: serve(args["batch"]["tokens"], args["cache"], sh.seq_len - 1)


def _leaves(tree):
    """The leaves of a nested dict (tensors or specs), in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def argument_bytes(mesh: dict, args: dict, kind: str) -> dict:
    """Bytes a device holds of each argument group under the sharding
    rules (``runtime.sharding``): {group: bytes}."""
    pb = lambda t, s: shlib.per_device_bytes(mesh, t, s)  # noqa: E731
    params = args["params"]
    pspecs = shlib.param_specs(mesh, params, serve=kind != "train")
    out = {"params": sum(pb(params[k], s) for k, s in pspecs.items())}
    if "opt" in args:
        opt = args["opt"]
        eight = isinstance(next(iter(opt["m"].values()), None), dict)
        ospecs = (shlib.opt8_specs if eight else shlib.opt_specs)(mesh, opt, pspecs)
        total = pb(opt["step"], ospecs["step"])
        for mom in ("m", "v"):
            for k, leaf in opt[mom].items():
                spec = ospecs[mom][k]
                total += (pb(leaf["q"], spec["q"]) + pb(leaf["scale"], spec["scale"])) if eight else pb(leaf, spec)
        out["opt"] = total
    bspecs = shlib.batch_specs(mesh, args["batch"])
    out["batch"] = sum(pb(t, bspecs[k]) for k, t in args["batch"].items())
    if "cache" in args:
        cspecs = shlib.cache_specs(mesh, args["cache"], args["batch"]["tokens"].shape[0])
        out["cache"] = sum(pb(t, s) for t, s in zip(_leaves(args["cache"]), _leaves(cspecs)))
    return out


def analyze_step(lm: LM, sh: Shape, *, microbatches: int = 1, optimizer: str = "adamw"):
    """Run the cell's step once on a ``meta`` ``lm`` under ``OpAnalysis``
    (microbatches trip-count-aware): (its OpCost, the arguments, the
    outputs, seconds)."""
    args = step_arguments(lm, sh, optimizer=optimizer)
    step = make_step(lm, sh, microbatches=microbatches, optimizer=optimizer)
    t0 = time.perf_counter()
    with OpAnalysis(trips=True) as mode:
        outs = step(args)
    return mode.cost, args, outs, time.perf_counter() - t0


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree) if isinstance(t, torch.Tensor))


def _spec_bytes(tree, specs, mesh) -> int:
    """Bytes of a rank's blocks of ``tree`` (tensors) under ``specs``."""
    return sum(math.prod(shlib.block_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip(_leaves(tree), _leaves(specs)))


def rank_step(lm: LM, sh: Shape, mesh, *, microbatches: int = 1, optimizer: str = "adamw",
              compress_pod_grads: bool = False, fill=None):
    """The cell's sharded step on this rank of ``mesh`` (placed over a
    process group), built from the whole ``lm`` on the rank's device:
    (``step()``, the bytes of the blocks the rank holds by group, the whole
    arguments on ``meta``). The rank's rows of the batch (``shard_batch``)
    and its cache blocks are cut from ``step_arguments``' ``meta`` tensors,
    ``fill`` mapping each batch tensor and each cache block to one with
    values on the rank's device (None: the ``meta`` tensors as they are)."""
    put = fill or (lambda t: t)
    whole = step_arguments(LM(lm.cfg, device="meta"), sh, optimizer=optimizer)
    blocks = lambda tree: shard_batch({k: put(v) for k, v in tree.items()}, mesh)  # noqa: E731
    if sh.kind == "train":
        tcfg = TrainConfig(microbatches=microbatches, optimizer=optimizer, compress_pod_grads=compress_pod_grads)
        train, _ = build_train_step(lm, tcfg, mesh=mesh)
        held = {"params": dict(lm.named_parameters()), "opt": init_opt_state(lm, optimizer),
                "batch": blocks(whole["batch"])}
        return (lambda: train(held["opt"], held["batch"])), {k: _nbytes(v) for k, v in held.items()}, whole
    if sh.kind == "prefill":
        prefill, _ = build_prefill_step(lm, mesh=mesh)
        held = {"params": dict(lm.named_parameters()), "batch": blocks(whole["batch"])}
        return (lambda: prefill(held["batch"])), {k: _nbytes(v) for k, v in held.items()}, whole
    serve, (psh, csh, tsh, _), _ = build_serve_step(lm, sh.global_batch, sh.seq_len, mesh=mesh)
    cache = shlib.tree_map(put, shlib.local_blocks(whole["cache"], csh, mesh))
    tokens = put(shlib.local_block(whole["batch"]["tokens"], tsh, mesh))
    held = {"params": _spec_bytes(whole["params"], psh, mesh), "batch": _nbytes(tokens), "cache": _nbytes(cache)}
    return (lambda: serve(tokens, cache, sh.seq_len - 1)), held, whole


def parameter_gathers(lm: LM, specs: dict, mesh: dict, calls) -> list:
    """The calls among ``calls`` (``launch.mesh.received``'s descriptions)
    that gather a parameter: an ``all_gather`` whose buffer has a
    parameter's type and the shape of its block under ``specs`` gathered
    over any of the mesh axes that cut it (none, some or all of them)."""
    blocks = set()
    for name, p in lm.named_parameters():
        spec = specs[name]
        axes = sorted({a for e in spec for a in spec_axes(e) if mesh.get(a, 1) > 1})
        dtype = str(p.dtype).removeprefix("torch.")
        for k in range(len(axes) + 1):
            for cut in itertools.combinations(axes, k):
                sub = tuple(tuple(a for a in spec_axes(e) if a in cut) or None for e in spec)
                blocks.add(f"{dtype}[{','.join(str(n) for n in shlib.block_shape(p.shape, sub, mesh))}]")
    return sorted(d for d in calls if d.startswith("all_gather ") and d.split(" ")[2] in blocks)


def analyze_rank_step(cfg, sh: Shape, mesh_shape: dict, *, rank: int = 0, microbatches: int = 1,
                      optimizer: str = "adamw", compress_pod_grads: bool = False):
    """Rank ``rank``'s sharded step of the cell (``rank_step``), built on a
    whole ``meta`` ``LM`` over ``meta_rank_mesh(mesh_shape, rank)`` and run
    once under ``OpAnalysis(trips=True)`` with ``received`` zeroed: (its
    OpCost, ``received``'s counts and calls, the whole arguments, the bytes
    of the blocks the rank holds by group, the outputs, seconds, (total,
    active) parameters). A decode step's counts also list the calls that
    gather a block of a parameter (``parameter_gathers``)."""
    with meta_rank_mesh(mesh_shape, rank) as mesh:
        lm = LM(cfg, device="meta")
        params = count_params(lm, cfg)
        step, held, whole = rank_step(lm, sh, mesh, microbatches=microbatches, optimizer=optimizer,
                                      compress_pod_grads=compress_pod_grads)
        received.zero()
        t0 = time.perf_counter()
        with OpAnalysis(trips=True) as mode:
            outs = step()
        secs = time.perf_counter() - t0
        coll = received.read()
        coll["calls"] = {d: list(c) for d, c in received.calls.items()}
        if sh.kind == "decode":
            coll["parameter_gathers"] = parameter_gathers(lm, shlib.param_specs(mesh, lm, serve=True), mesh,
                                                          coll["calls"])
    return mode.cost, coll, whole, held, outs, secs, params


def run_cell(arch: str, shape_name: str, mesh_arg: str, *, reduced: bool = False,
             microbatches: int | None = None, remat_policy: str | None = None, optimizer: str = "adamw",
             compress_pod_grads: bool = False) -> dict:
    """The cell's record (module note): the one-device program on a mesh of
    one, rank 0's sharded program on a larger one."""
    cfg = get_config(arch, reduced=reduced)
    if remat_policy:
        cfg = cfg.replace(remat_policy=remat_policy)
    sh = SHAPES[shape_name]
    if reduced:
        # shrink shapes proportionally for CI smoke of the dry-run path
        sh = Shape(sh.name, min(sh.seq_len, 256), max(4, sh.global_batch // 32), sh.kind)
    mesh = mesh_from_arg(mesh_arg)
    mb = 1
    if sh.kind == "train":
        mb = microbatches if microbatches is not None else auto_microbatches(cfg, sh, mesh)
    if math.prod(mesh.values()) == 1:
        lm = LM(cfg, device="meta")
        cost, args, outs, secs = analyze_step(lm, sh, microbatches=mb, optimizer=optimizer)
        params = count_params(lm, cfg)
        coll = held = None
    else:
        cost, coll, args, held, outs, secs, params = analyze_rank_step(
            cfg, sh, mesh, microbatches=mb, optimizer=optimizer, compress_pod_grads=compress_pod_grads)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_arg, "reduced": reduced,
           "compile_seconds": round(secs, 1), **cell_record(cfg, sh, mesh, cost, args, outs, *params, coll=coll)}
    if held is not None:
        rec["memory"]["held_groups"] = held
        if held != rec["memory"]["argument_groups"]:
            raise AssertionError(f"{arch} {shape_name} {mesh_arg}: the rank holds {held} bytes, the rules count "
                                 f"{rec['memory']['argument_groups']}")
    if sh.kind == "train":
        rec["microbatches"] = mb
        rec["optimizer"] = optimizer
        rec["compress_pod_grads"] = compress_pod_grads
    return rec


def _collectives(coll: dict | None) -> dict:
    """The record's ``collectives`` from ``received``'s counts and calls:
    bytes received in all, by kind (count and bytes), the largest calls,
    and for a decode step the calls that gather a parameter's block, each
    with its count and bytes a call."""
    if coll is None:
        return {"total_bytes": 0.0, "by_op": {}, "top": []}
    by_op = {k: {"count": 0, "bytes": b} for k, b in coll["by_kind"].items()}
    for desc, (count, _) in coll["calls"].items():
        by_op[desc.split(" ", 1)[0]]["count"] += count
    out = {"total_bytes": coll["total"], "by_op": by_op, "top": coll["top"], "largest": coll["largest"]}
    if "parameter_gathers" in coll:
        out["parameter_gathers"] = {d: coll["calls"][d] for d in coll["parameter_gathers"]}
    return out


def cell_record(cfg, sh: Shape, mesh: dict, cost, args: dict, outs, total_p: float, active_p: float, *,
                coll: dict | None = None) -> dict:
    """The record of one analysed step (``run_cell``'s keys but the cell's
    names) on ``mesh``: ``cost`` and ``coll`` (``received``'s counts) are
    one device's program, ``args`` the whole arguments."""
    n_dev = math.prod(mesh.values())
    kind = sh.kind
    tokens = sh.global_batch * (sh.seq_len if cfg.family != "encdec" else 448)
    flops_mult = 6.0 if kind == "train" else 2.0
    if kind == "decode":
        tokens = sh.global_batch
    groups = argument_bytes(mesh, args, kind)
    arg_b = sum(groups.values())
    if kind == "train":
        alias = groups["params"] + groups["opt"]
        out_b = alias + _nbytes(outs)                       # the step's metrics
    elif kind == "prefill":
        alias, out_b = 0, _nbytes(outs)
    else:
        alias = groups["cache"]
        out_b = alias + _nbytes(outs[0])
    colls = _collectives(coll)
    flops, hbm, temp_b = cost.flops, cost.hbm_bytes, cost.peak_bytes
    model_flops = flops_mult * active_p * tokens
    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": hbm / HBM_BW,
             "collective_s": colls["total_bytes"] / NVLINK_RX_BW}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    rec = {
        "kind": kind, "n_devices": n_dev,
        "memory": {
            "argument_bytes": arg_b, "output_bytes": out_b, "temp_bytes": temp_b, "alias_bytes": alias,
            "peak_per_device_gb": round((arg_b + temp_b) / 2**30, 3),
            "argument_groups": groups,
        },
        "cost": {
            "hlo_flops": flops, "hlo_bytes": hbm,
            # the aten operators' part alone, the kernels' charges left out
            "xla_raw_flops": cost.aten_flops, "xla_raw_bytes": cost.aten_bytes, "ops": cost.ops,
        },
        "collectives": colls,
        "top_hbm_ops": [f"{b / 2**30:.2f}GiB {d}" for b, d in cost.top_hbm],
        "kernels": cost.by_kernel,
        "params": {"total": total_p, "active": active_p},
        "tokens_per_step": tokens,
        "model_flops_per_device": model_flops / n_dev,
        "useful_flops_ratio": (model_flops / n_dev) / flops if flops else 0.0,
        "roofline_terms": terms,
        "memory_s_kernelized": (hbm - cost.score_hbm_bytes) / HBM_BW,
        "dominant_term": dominant,
        "step_time_lower_bound_s": bound,
        "roofline_fraction": (model_flops / n_dev) / PEAK_FLOPS / bound if bound > 0 else 0.0,
        "device": "H100", "peaks": {"flops_per_s": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
                                    "nvlink_rx_bytes_per_s": NVLINK_RX_BW},
        "fits_device_memory": arg_b + temp_b <= DEVICE_BYTES,
    }
    if kind == "decode":
        rec["decode_pos"] = sh.seq_len - 1
    if n_dev > 1:
        rec["collective_link"] = COLLECTIVE_LINK
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", help="single | multi | both | AxB[xC] (1: one H100)")
    ap.add_argument("--all", action="store_true", help="sweep all runnable cells")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--reduced", action="store_true", help="smoke mode: reduced configs + shrunken shapes")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--moe-impl", default=None, choices=["gather", "a2a", "auto"],
                    help="MoE dispatch (models.moe.set_moe_impl); a2a and auto apply on a mesh of more than one "
                         "device")
    ap.add_argument("--remat-policy", default=None, choices=["full", "dots"])
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adamw8"])
    ap.add_argument("--compress-pod-grads", action="store_true",
                    help="int8 gradient sum over the pod axis (runtime.train; a no-op without one)")
    args = ap.parse_args(argv)
    prev_impl = moe.MOE_IMPL
    moe.set_moe_impl(args.moe_impl or prev_impl)
    try:
        _sweep(ap, args)
    finally:
        moe.set_moe_impl(prev_impl)


def _sweep(ap, args) -> None:
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(a, s) for a, s, ok in cells(list_archs()) if ok]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        todo = [(args.arch, args.shape)]

    failures = []
    t_all = time.perf_counter()
    for arch, shape in todo:
        for mesh_arg in meshes:
            tag = f"{arch}__{shape}__{mesh_arg}{'__reduced' if args.reduced else ''}"
            try:
                rec = run_cell(arch, shape, mesh_arg, reduced=args.reduced, microbatches=args.microbatches,
                               remat_policy=args.remat_policy, optimizer=args.optimizer,
                               compress_pod_grads=args.compress_pod_grads)
                (out / f"{tag}.json").write_text(json.dumps(rec, indent=1))
                t = rec["roofline_terms"]
                print(f"[ok] {tag}: dominant={rec['dominant_term']} compute={t['compute_s']:.6f}s "
                      f"memory={t['memory_s']:.6f}s coll={t['collective_s']:.6f}s "
                      f"mem/dev={rec['memory']['peak_per_device_gb']}GB "
                      f"fits={rec['fits_device_memory']} analysis={rec['compile_seconds']}s", flush=True)
            except Exception as e:  # noqa: BLE001 — a sweep reports every cell, then fails
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e!r}", flush=True)
    print(f"{len(todo) * len(meshes) - len(failures)} records in {time.perf_counter() - t_all:.1f} s")
    if failures:
        print(f"{len(failures)} failures:")
        for tag, err in failures:
            print(" ", tag, err[:200])
        sys.exit(1)
    print("all cells analysed OK")


if __name__ == "__main__":
    main()
