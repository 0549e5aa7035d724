"""Serving CLI: DIANA-queued batched inference.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b --requests 16 --slots 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b --device cpu

The reference's flags, plus ``--device`` (default: the CUDA card; the
run raises without one). As in the reference, ``--reduced`` is on by
default and cannot be switched off here, so the CLI always serves the
reduced configuration; ``chip_smoke.py`` drives the full width through
the library. Weights are random, drawn from a seeded generator on the
device. The dense, moe (deepseek-v2-236b, deepseek-v3-671b), hybrid
(recurrentgemma-2b) and ssm (mamba2-780m) families serve; vlm and encdec
need image or audio embeddings that the engine does not take, and raise,
as the reference's engine does.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.models import LM
from repro_torch.serving import InferenceRequest, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced).replace(remat=False)
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    engine = ServingEngine(lm, num_slots=args.slots, max_len=args.max_len,
                           quotas={"tenant-a": 100.0, "tenant-b": 100.0})
    reqs = []
    for i in range(args.requests):
        r = InferenceRequest(
            user=f"tenant-{'ab'[i % 2]}",
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new_tokens=args.new_tokens)
        reqs.append(r)
        engine.submit(r, now=float(i))
    t0 = time.time()
    stats = engine.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    tokens = sum(len(r.generated) for r in reqs)
    print(f"served={stats.served}/{args.requests} batches={stats.batches} "
          f"decode_steps={stats.decode_steps} tokens={tokens} "
          f"({tokens / dt:.1f} tok/s wall, {dev})")
    return stats, reqs


if __name__ == "__main__":
    main()
