"""AdamW with float32 moments over a name → tensor dict of parameters
(``repro.optim.adamw``), updated in place."""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "bias_corrections"]


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def _step_device(params: dict) -> torch.device:
    return next(iter(params.values())).device if params else torch.device("cpu")


def adamw_init(params: dict) -> dict:
    """{"m": {name: f32 zeros}, "v": {…}, "step": int64 0} on the
    parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {
        "m": {n: zeros(p) for n, p in params.items()},
        "v": {n: zeros(p) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int64, device=_step_device(params)),
    }


def bias_corrections(step: torch.Tensor, cfg: AdamWConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """1 − b1**step and 1 − b2**step in float32, as the reference's
    ``b ** step.astype(float32)`` (not as Python doubles)."""
    s = step.to(torch.float32)
    return (1.0 - torch.pow(s.new_tensor(cfg.b1), s), 1.0 - torch.pow(s.new_tensor(cfg.b2), s))


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, lr, cfg: AdamWConfig = AdamWConfig()) -> dict:
    """One AdamW step in place: the moments in float32, decay on ≥ 2-D
    leaves only, each parameter rewritten as (p.f32 − lr·delta) in its
    type. Returns ``state`` (its step advanced)."""
    state["step"] += 1
    b1c, b2c = bias_corrections(state["step"], cfg)
    for name, p in params.items():
        g32 = grads[name].float()
        m, v = state["m"][name], state["v"][name]
        m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g32) * (1 - cfg.b2))
        del g32
        delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        if p.dim() >= 2:
            delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
    return state
