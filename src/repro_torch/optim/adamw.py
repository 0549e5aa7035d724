"""AdamW with float32 moments over a name → tensor dict of parameters
(``repro.optim.adamw``), updated in place.

The reference decays every leaf of two or more dimensions, and its
leaves stack a family's layers (``models.interop.STACKED``): a layer's
norm scale is a row of a stacked (L, d) leaf there, and decays. The port
keeps one parameter a layer, so ``decays`` counts the stacking axes of
a ``<stack>.<i>….<rest>`` name with the parameter's own."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.interop import STACKED

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "bias_corrections", "decays", "stack_position"]


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def stack_position(name: str) -> tuple[tuple[str, ...], tuple[int, ...]] | None:
    """Where parameter ``<stack>.<i>[.<j>].<rest>`` sits in the reference's
    stacked leaf: ((<stack>, *<rest>), (i[, j])), or None for a leaf the
    reference does not stack."""
    parts = name.split(".")
    n = STACKED.get(parts[0], 0)
    if not n or len(parts) <= n + 1 or not all(x.isdigit() for x in parts[1:n + 1]):
        return None
    return (parts[0], *parts[n + 1:]), tuple(map(int, parts[1:n + 1]))


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether weight decay applies to parameter ``name``: its leaf in the
    reference has two or more dimensions (the stacking axes included)."""
    pos = stack_position(name)
    return p.dim() + (len(pos[1]) if pos else 0) >= 2


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
    """One AdamW step in place: the moments in float32, decay where the
    reference's leaf is ≥ 2-D (``decays``), each parameter rewritten as
    (p.f32 − lr·delta) in its type. Returns ``state`` (its step advanced)."""
    state["step"] += 1
    b1c, b2c = bias_corrections(state["step"], cfg)
    for name, p in params.items():
        g32 = grads[name].float()
        m, v = state["m"][name], state["v"][name]
        m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g32) * (1 - cfg.b2))
        del g32
        delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        if decays(name, p):
            delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
    return state
