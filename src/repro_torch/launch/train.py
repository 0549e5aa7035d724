"""Training CLI (the port of ``repro.launch.train``), on one device or on
every rank of a process group.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b --reduced --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b --reduced --steps 20
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --reduced --device cpu

The reference's flags, plus ``--device`` (default: the CUDA card; the
run raises without one). Weights are random, drawn from a seeded
generator on the device; the data is
``SyntheticLMDataset(vocab, seq, seed=1)``; vlm and encdec get zero image /
audio embeddings, as in the reference. With ``--ckpt-dir`` it saves
asynchronously every ``--ckpt-every`` steps and at the end, and resumes
from the newest checkpoint. A checkpoint's tag is the number of steps it
holds (the reference tags a mid-run save with the index of the step just
taken and so repeats that step on resume: ROADMAP.md C5).
``chip_smoke.py`` drives the full width through the library.

Under a process group of more than one rank (initialised by the caller,
as ``launch.mesh.run_ranks`` does, or here from ``torchrun``'s
environment: gloo on the host, nccl on cards) it trains under
``make_mesh_from_ranks`` (the reference's rule: 'model' the first of 16,
8, 4, 2, 1 that divides the world, 'data' the rest): every rank draws
the whole model and the global batch, keeps its blocks and its rows, and
runs the sharded step (``runtime.train.build_train_step(...,
mesh=...)``). A save gathers the whole tensors a leaf at a time onto rank
0's host (``runtime.sharding.gather_blocks``) and rank 0 writes them in
the one-device format, so either reads the other's checkpoints; a
restore reads them on the host and cuts the blocks again. Every family
trains under a mesh (the vlm's and encdec's zero embeddings cut by rows
with the batch; the moe family's experts by ``param_specs``, its aux loss
counted once). Rank 0 prints.
"""
import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, list_archs
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.mesh import make_mesh_from_ranks
from repro_torch.models import LM
from repro_torch.runtime.sharding import gather_blocks, local_blocks, tree_map
from repro_torch.runtime.train import TrainConfig, build_train_step, init_opt_state, shard_batch


def _process_group(args) -> bool:
    """Start the process group from ``torchrun``'s environment where it is
    not started and names more than one rank; whether this call started it."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    dist.init_process_group("gloo" if cpu else "nccl", init_method="env://")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    started = _process_group(args)
    try:
        return _train(args)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args):
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = resolve_device(args.device)
    if world > 1 and dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.reduced:
        cfg = cfg.replace(remat=False)
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    mesh = make_mesh_from_ranks(device_type=dev.type) if world > 1 else None
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"arch={cfg.name} device={dev} " + (f"mesh={dict(mesh)} " if mesh else "") + f"devices={world}")

    tcfg = TrainConfig(microbatches=args.microbatches,
                       total_steps=args.steps, warmup_steps=max(1, args.steps // 10))
    if mesh is None:
        step_fn = build_train_step(lm, tcfg)
    else:
        step_fn, specs = build_train_step(lm, tcfg, mesh=mesh)
    params = dict(lm.named_parameters())
    opt = init_opt_state(lm, tcfg.optimizer)

    ckpt = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        if mesh is None:
            (saved, opt), start = ckpt.restore((params, opt), device=dev)
        else:       # whole on the host, this rank's blocks on its device
            (saved, saved_opt), start = ckpt.restore((params, opt))
            saved = local_blocks(saved, specs[0], mesh)
            opt = tree_map(lambda t: t.to(dev, copy=True), local_blocks(saved_opt, specs[1], mesh))
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])
        say(f"restored step {start}")

    def save(step: int) -> None:
        if mesh is None:
            ckpt.save_async(step, (params, opt))
            return
        tree = tuple(gather_blocks(t, sp, mesh, keep=rank == 0) for t, sp in zip((params, opt), specs))
        if rank == 0:
            ckpt.save_async(step, tree)

    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, seed=1)
    t0 = time.time()
    for step in range(start, args.steps):
        batch = dict(ds.batch(step, args.global_batch))
        if cfg.family == "vlm":
            batch["image_embeds"] = torch.zeros(
                (args.global_batch, cfg.num_image_tokens, cfg.d_model), dtype=cfg.cdtype, device=dev)
        if cfg.family == "encdec":
            batch["audio_embeds"] = torch.zeros(
                (args.global_batch, max(cfg.encoder_seq_len, 64), cfg.d_model), dtype=cfg.cdtype, device=dev)
        metrics = step_fn(opt, batch if mesh is None else shard_batch(batch, mesh))
        if step % 10 == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"{(time.time() - t0) / (step - start + 1):.2f}s/step",
                flush=True)
        if ckpt and step and step % args.ckpt_every == 0:
            save(step + 1)
    if ckpt:
        if rank == 0:
            ckpt.wait()
        save(args.steps)
        if rank == 0:
            ckpt.wait()
    say("training complete")
    return lm, opt


if __name__ == "__main__":
    main()
