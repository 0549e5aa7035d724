"""Block-wise int8-quantized AdamW moments (``repro.optim.adamw8``).

Moments are stored int8 with one float32 scale per block. Blocks tile
the parameter's last axis (``block_size``: the largest divisor ≤ 256),
so each moment is ``{"q": int8 param.shape[:-1] + (nb, b), "scale":
float32 param.shape[:-1] + (nb,)}``; the second moment is stored as
√v. Codes round half to even (``torch.round``, as ``jnp.round``).
"""
from __future__ import annotations

import torch

from .adamw import AdamWConfig, bias_corrections

__all__ = ["adamw8_init", "adamw8_update", "block_size"]

_TARGET_BLOCK = 256


def block_size(last_dim: int) -> int:
    """Largest divisor of last_dim ≤ 256 (no padding, ever).

    When the dim is 16-divisible (i.e. potentially mesh-sharded) the
    block count nb = last_dim/b is kept 16-divisible too, so the
    quantized state shards exactly like the parameter."""
    cands = [b for b in range(min(_TARGET_BLOCK, last_dim), 0, -1)
             if last_dim % b == 0]
    if last_dim % 16 == 0 and last_dim >= 1024:   # mesh-shardable dims
        for b in cands:
            if (last_dim // b) % 16 == 0 and b >= 64:
                return b
        for b in cands:
            if (last_dim // b) % 16 == 0:
                return b
    return cands[0] if cands else 1


def _quantize(x32: torch.Tensor) -> dict:
    """param-shaped float32 → {q int8 (..., nb, b), scale float32 (..., nb)}."""
    last = x32.shape[-1]
    b = block_size(last)
    xb = x32.reshape(x32.shape[:-1] + (last // b, b))
    scale = torch.clamp(torch.amax(torch.abs(xb), dim=-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _dequantize(m: dict, shape) -> torch.Tensor:
    return (m["q"].float() * m["scale"][..., None]).reshape(shape)


def _qshape(p: torch.Tensor) -> tuple:
    last = p.shape[-1] if p.dim() else 1
    b = block_size(max(last, 1))
    return tuple(p.shape[:-1]) + (max(last, 1) // b, b)


def adamw8_init(params: dict) -> dict:
    def zeros(p):
        qshape = _qshape(p)
        return {"q": torch.zeros(qshape, dtype=torch.int8, device=p.device),
                "scale": torch.zeros(qshape[:-1], dtype=torch.float32, device=p.device)}

    dev = next(iter(params.values())).device if params else torch.device("cpu")
    return {
        "m": {n: zeros(p) for n, p in params.items()},
        "v": {n: zeros(p) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int64, device=dev),
    }


@torch.no_grad()
def adamw8_update(grads: dict, state: dict, params: dict, lr, cfg: AdamWConfig = AdamWConfig()) -> dict:
    """One step in place: dequantize, the float32 AdamW update, requantize
    m and √v; returns ``state``."""
    state["step"] += 1
    b1c, b2c = bias_corrections(state["step"], cfg)
    for name, p in params.items():
        shape = p.shape if p.dim() else (1,)
        g32 = grads[name].float().reshape(shape)
        mq, vq = state["m"][name], state["v"][name]
        m = cfg.b1 * _dequantize(mq, shape) + (1 - cfg.b1) * g32
        v = cfg.b2 * torch.square(_dequantize(vq, shape)) + (1 - cfg.b2) * torch.square(g32)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta.reshape(p.shape))
        for old, new in ((mq, _quantize(m)), (vq, _quantize(torch.sqrt(v)))):
            old["q"].copy_(new["q"])
            old["scale"].copy_(new["scale"])
    return state
