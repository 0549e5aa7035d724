"""Global-norm gradient clipping (``repro.optim.clip``), in place."""
from __future__ import annotations

import torch

__all__ = ["clip_by_global_norm"]


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale every gradient of ``grads`` (name → tensor) in place by
    min(1, max_norm / max(‖g‖, 1e-12)), each through float32 and back to
    its type; returns (grads, the float32 global norm ‖g‖)."""
    leaves = list(grads.values())
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    # tensor / tensor: a true division, as the reference's (scalar / tensor
    # would multiply by a reciprocal)
    scale = torch.clamp(gn.new_tensor(max_norm) / torch.clamp(gn, min=1e-12), max=1.0)
    for g in leaves:
        g.copy_(g.float() * scale)
    return grads, gn
