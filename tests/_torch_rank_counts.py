"""The port's side of ``tests/test_torch_rank_counts.py``: what each gloo
rank runs (spawned by ``launch.mesh.run_ranks``, so it lives in a module
the ranks import; it imports no JAX).

``CASES`` are the six families' reduced training (2 microbatches),
prefill and decode steps at small shapes; ``counts(mesh)`` builds each
case's step on this rank through the dry run's own ``rank_step``, its
inputs filled with values drawn from a seed, runs it once under
``OpAnalysis`` with ``launch.mesh.received`` zeroed and returns, for each
case, the FLOPs and the bytes received (by kind, the largest call, each
distinct call's count): what ``launch.dryrun.analyze_rank_step`` counts on
``meta`` for one rank.
"""
from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import received
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.models import LM

ARCHS = ("gemma2-9b", "recurrentgemma-2b", "mamba2-780m", "llama-3.2-vision-11b", "whisper-base",
         "deepseek-v2-236b")
SHAPES = {"train": Shape("train_4k", 32, 8, "train"), "prefill": Shape("prefill_32k", 32, 8, "prefill"),
          # max_len 256: a cache a rank cuts over 'model' (S/m ≥ 128 at m = 2), the sharded decode's path
          "decode": Shape("decode_32k", 256, 8, "decode")}
MICROBATCHES = 2
CASES = [(a, k) for a in ARCHS for k in SHAPES]


def step_of(lm: LM, kind: str, mesh, fill=None):
    """``dryrun.rank_step`` of a case on this rank."""
    return dryrun.rank_step(lm, SHAPES[kind], mesh, microbatches=MICROBATCHES if kind == "train" else 1, fill=fill)


def counts(mesh) -> dict:
    """(arch, kind) → {"flops", "by_kind", "largest", "calls"} of this
    rank's step, run on the CPU with values."""
    gen = torch.Generator().manual_seed(0)
    out = {}
    for arch, kind in CASES:
        cfg = get_config(arch, reduced=True)
        lm = LM(cfg, device="cpu").init(gen)

        def fill(t, cfg=cfg):
            if t.dtype.is_floating_point:
                return (torch.randn(t.shape, generator=gen) * 0.1).to(t.dtype)
            return torch.randint(0, cfg.vocab_size, t.shape, generator=gen, dtype=t.dtype)

        step, _, _ = step_of(lm, kind, mesh, fill)
        received.zero()
        with OpAnalysis() as mode:
            step()
        out[(arch, kind)] = {"flops": int(mode.cost.flops), **received.read(),
                             "calls": {d: list(c) for d, c in received.calls.items()}}
    return out
