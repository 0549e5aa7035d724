"""Train and prefill steps on one device (``repro.runtime.train``
without the mesh).

``build_train_step(lm, tcfg)`` returns ``train_step(opt, batch)``,
which updates ``lm``'s parameters and the optimizer state ``opt`` in
place and returns ``{"loss", "grad_norm", "lr"}``: the gradients of
``lm.loss`` (microbatches accumulated in float32 and averaged, as the
reference's scan does), clipped by global norm, a linear-warmup cosine
learning rate at the step before the update, then AdamW or its int8
variant. ``TrainConfig.compress_pod_grads`` does nothing on one device,
as in the reference, which compresses only across more than one pod.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._counting import trips
from ..models import LM
from ..optim import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm, linear_warmup_cosine
from ..optim.adamw8 import adamw8_init, adamw8_update

__all__ = ["TrainConfig", "build_train_step", "build_prefill_step", "abstract_train_state", "init_opt_state"]


@dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0
    microbatches: int = 1
    compress_pod_grads: bool = False   # EF-int8 cross-pod all-reduce (no pod here)
    optimizer: str = "adamw"           # 'adamw' | 'adamw8' (int8 moments)
    adamw: AdamWConfig = AdamWConfig()


def _init_fn(optimizer: str):
    if optimizer not in ("adamw", "adamw8"):
        raise ValueError(f"optimizer must be 'adamw' or 'adamw8', got {optimizer!r}")
    return adamw8_init if optimizer == "adamw8" else adamw_init


def init_opt_state(lm: LM, optimizer: str = "adamw") -> dict:
    """Zero optimizer state for ``lm``'s parameters, on their device."""
    return _init_fn(optimizer)(dict(lm.named_parameters()))


def abstract_train_state(lm: LM, optimizer: str = "adamw"):
    """(parameters, optimizer state) of ``lm``'s configuration as tensors on
    the ``meta`` device: shapes and types, no storage (the reference's
    ``seed`` argument drops out: nothing is drawn)."""
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


def build_train_step(lm: LM, tcfg: TrainConfig = TrainConfig()):
    """``train_step(opt, batch) → {"loss", "grad_norm", "lr"}`` for ``lm``
    on its device; turns ``lm``'s gradients on."""
    update = adamw8_update if tcfg.optimizer == "adamw8" else adamw_update
    _init_fn(tcfg.optimizer)
    lm.requires_grad_(True)
    params = dict(lm.named_parameters())

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
        if any(v.shape[0] % n for v in batch.values()):
            raise ValueError(f"batch of {next(iter(batch.values())).shape[0]} does not split into {n} microbatches")
        gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
        lsum = torch.zeros((), dtype=torch.float32, device=lm.device)
        for i in trips(n):      # one counted trip, scaled by n, under the dry run's analysis
            mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i] for k, v in batch.items()}
            lsum += backward(mb)
            for k, p in params.items():
                if p.grad is not None:
                    gsum[k] += p.grad.float()
                p.grad = None
        inv = 1.0 / n
        return {k: g.mul_(inv) for k, g in gsum.items()}, lsum * inv

    def train_step(opt: dict, batch: dict) -> dict:
        grads, loss = grads_of(_on(lm.device, batch))
        grads, gnorm = clip_by_global_norm(grads, tcfg.max_grad_norm)
        lr = linear_warmup_cosine(opt["step"], tcfg.warmup_steps, tcfg.total_steps, tcfg.peak_lr)
        update(grads, opt, params, lr, tcfg.adamw)
        for p in params.values():
            p.grad = None
        return {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def build_prefill_step(lm: LM):
    """Forward-only step (inference prefill): batch → the final
    position's logits (B, 1, V); the (B, S, V) tensor never exists."""

    def prefill_step(batch: dict) -> torch.Tensor:
        batch = _on(lm.device, batch)
        logits, _ = lm.forward(batch["tokens"], image_embeds=batch.get("image_embeds"),
                               audio_embeds=batch.get("audio_embeds"), last_only=True)
        return logits

    return prefill_step
