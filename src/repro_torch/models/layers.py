"""Shared layers: norms, embeddings, RoPE, MLP variants.

Plain tensor functions with the reference's arithmetic
(``repro.models.layers``): norms and rotary angles in float32, results
cast back to the input's type. Initializers fill a given tensor from an
explicit ``torch.Generator`` (the numbers differ from ``jax.random``'s
for the same seed; ``models.interop`` carries reference weights across
when both must compute the same thing).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "softcap", "rms_norm", "init_linear_", "init_embedding_", "linear", "embed",
    "rope", "mlp",
]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap·tanh(x/cap)."""
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    # scale is stored as (scale − 1) so zeros == identity (gemma convention)
    return (x * (1.0 + scale.float())).to(dt)


@torch.no_grad()
def init_linear_(w: torch.Tensor, d_in: int, generator: torch.Generator,
                 scale: float | None = None) -> torch.Tensor:
    """Fill ``w`` with N(0, 1)·scale drawn in float32 (scale 1/√d_in by
    default), rounded to ``w``'s type."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    draw = torch.randn(w.shape, generator=generator, dtype=torch.float32, device=w.device)
    return w.copy_(draw.mul_(scale))


@torch.no_grad()
def init_embedding_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return init_linear_(w, 1, generator, scale=0.02)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) · w (d, f) → (..., f)."""
    return torch.matmul(x, w)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


# -- RoPE -------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D) or (..., S, D); positions (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freq      # (..., S, half)
    if x.dim() == angles.dim() + 1:                                # head axis present
        angles = angles[..., None, :]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLP variants -------------------------------------------------------------

def mlp(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """``params`` maps ``w_gate``/``w_up``/``w_down`` to (d, f)/(f, d)."""
    if kind == "swiglu":
        h = F.silu(linear(x, params["w_gate"])) * linear(x, params["w_up"])
    elif kind == "geglu":
        h = F.gelu(linear(x, params["w_gate"]), approximate="tanh") * linear(x, params["w_up"])
    elif kind == "squared_relu":               # nemotron-4
        h = torch.square(F.relu(linear(x, params["w_up"])))
    elif kind == "gelu":                       # whisper
        h = F.gelu(linear(x, params["w_up"]), approximate="tanh")
    else:
        raise ValueError(kind)
    return linear(h, params["w_down"])
