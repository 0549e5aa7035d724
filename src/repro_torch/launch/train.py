"""Training CLI (the port of ``repro.launch.train``) on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b --reduced --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b --reduced --steps 20

The reference's flags, plus ``--device`` (default: the CUDA card; the
run raises without one). Weights are random, drawn from a seeded
generator on the device; the data is ``SyntheticLMDataset(vocab, seq,
seed=1)``; vlm and encdec get zero image / audio embeddings, as in the
reference. With ``--ckpt-dir`` it saves asynchronously every
``--ckpt-every`` steps and at the end, and resumes from the newest
checkpoint. A checkpoint's tag is the number of steps it holds (the
reference tags a mid-run save with the index of the step just taken and
so repeats that step on resume: ROADMAP.md C5). ``chip_smoke.py`` drives
the full width through the library.
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, list_archs
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import LM
from repro_torch.runtime.train import TrainConfig, build_train_step, init_opt_state


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

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.reduced:
        cfg = cfg.replace(remat=False)
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    print(f"arch={cfg.name} device={dev} devices=1")

    tcfg = TrainConfig(microbatches=args.microbatches,
                       total_steps=args.steps, warmup_steps=max(1, args.steps // 10))
    step_fn = build_train_step(lm, tcfg)
    params = dict(lm.named_parameters())
    opt = init_opt_state(lm, tcfg.optimizer)

    ckpt = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        (saved, opt), start = ckpt.restore((params, opt), device=dev)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])
        print(f"restored step {start}")

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
        metrics = step_fn(opt, batch)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"{(time.time() - t0) / (step - start + 1):.2f}s/step",
                  flush=True)
        if ckpt and step and step % args.ckpt_every == 0:
            ckpt.save_async(step + 1, (params, opt))
    if ckpt:
        ckpt.wait()
        ckpt.save_async(args.steps, (params, opt))
        ckpt.wait()
    print("training complete")
    return lm, opt


if __name__ == "__main__":
    main()
