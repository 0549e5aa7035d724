"""Error-feedback int8 gradient compression (``repro.optim.compress``).

g_sync = deq(Σ quant(g + e)) over a process group, and the residual e
accumulates locally (Karimireddy et al.-style EF). With no group it is
the single-device identity of the reference's ``shard_map`` over a pod
axis of one: the quantized gradient, dequantized."""
from __future__ import annotations

import torch

__all__ = ["quantize_int8", "dequantize_int8", "ef_int8_allreduce"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale)."""
    amax = torch.amax(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_int8_allreduce(grad: torch.Tensor, error: torch.Tensor, group=None):
    """One EF-compressed all-reduce over ``group`` (a
    ``torch.distributed`` process group; None: this device alone).

    Returns (synced mean gradient float32, new error residual)."""
    g = grad.float() + error
    q, scale = quantize_int8(g)
    new_error = g - dequantize_int8(q, scale)
    # int32 sums avoid int8 overflow across the group; scales are meaned alongside
    summed = q.to(torch.int32)
    scale_sum = scale.clone()
    n = torch.ones((), dtype=torch.float32, device=g.device)
    if group is not None:
        import torch.distributed as dist

        for t in (summed, scale_sum, n):
            dist.all_reduce(t, group=group)
    g_sync = summed.float() * (scale_sum / n) / n
    return g_sync, new_error
