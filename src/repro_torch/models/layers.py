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

from .._device import warm_host_math
from ..launch.mesh import all_reduce

__all__ = [
    "softcap", "rms_norm", "init_linear_", "init_embedding_", "linear", "embed",
    "rope", "mlp", "mlp_hidden", "row_parallel", "vocab_embed",
]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap·tanh(x/cap)."""
    if cap <= 0:
        return x
    warm_host_math(x)
    return cap * torch.tanh(x / cap)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    warm_host_math(x)
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


class _ProductF32(torch.autograd.Function):
    """x (..., k) · w (k, n) of a narrower type with a float32 result: the
    product's float32 accumulation returned unrounded (``torch.mm(...,
    out_dtype=)`` on the card). The gradient reaches x and w in their type,
    as the product's own backward gives it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        y = torch.mm(x2, w, out_dtype=torch.float32) if x.is_cuda else x2.float() @ w.float()
        return y.view(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.t(), x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])


def row_parallel(x: torch.Tensor, w: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """x (..., k) · w (k, n), k this rank's slice of the contraction, summed
    over ``axis`` (Megatron's row-parallel product over 'model'; the
    decode's weight-stationary projections over 'data'): each rank's
    partial product kept in float32 and the sum rounded once to x's type,
    as a one-device product rounds its float32 accumulation once (rounding
    each partial first would round twice)."""
    y = linear(x, w) if x.dtype == torch.float32 else _ProductF32.apply(x, w)
    return all_reduce(y, axis, mesh).to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[tokens], through ``F.embedding``: its backward sums repeated
    tokens' gradients in a fixed order (the backward of ``table[tokens]``,
    an accumulating ``index_put_``, adds them in thread order on the host
    and differs from run to run)."""
    return F.embedding(tokens, table)


def vocab_embed(tokens: torch.Tensor, block: torch.Tensor, v0: int, mesh, axis: str = "model") -> torch.Tensor:
    """table[tokens] from this rank's rows [v0, v0 + n) of the table
    (``block`` (n, d), Megatron's vocab-parallel embedding): each rank looks
    up the tokens that fall in its rows and gives zeros for the others, and
    the rows are summed over ``axis``. One rank adds a nonzero row, so the
    sum equals ``embed`` on the whole table exactly. Its backward gives
    every rank the whole gradient of the rows (the sum's backward), which
    it scatters into its own rows of the table."""
    local = tokens - v0
    inside = (local >= 0) & (local < block.shape[0])
    x = embed(torch.where(inside, local, 0), block)
    return all_reduce(torch.where(inside[..., None], x, 0), axis, mesh)


# -- RoPE -------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D) or (..., S, D); positions (..., S)."""
    warm_host_math(x)
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
    return linear(mlp_hidden(params, x, kind), params["w_down"])


def mlp_hidden(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """The MLP's activation (..., f), the input of ``w_down``."""
    warm_host_math(x)
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
    return h
