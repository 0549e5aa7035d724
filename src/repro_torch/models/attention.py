"""Attention: GQA with causal/local/global masks, soft-capping, and
KV-cache decode (the non-sharded half of ``repro.models.attention``).

``attention`` (prefill) runs the flash-attention kernel and
``decode_attention`` the decode-attention kernel on a CUDA tensor, and
their plain PyTorch versions on a host tensor, for every layer and
length (the reference's own model path runs jnp attention and reaches
its Pallas kernels only from tests). The decode path writes the new
token's key and value into the cache in place and returns the cache.

Left for later slices (ROADMAP.md): ``_chunked``/banded attention on the
host, cross-attention (vlm, encdec) and the sharded decode paths.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.decode_attention.ops import decode_attention as decode_attention_kernel
from ..kernels.flash_attention.ops import flash_attention
from .common import ModelConfig
from .layers import init_linear_, linear, rope

__all__ = [
    "init_attention", "init_attention_", "attention", "decode_attention", "init_kv_cache",
    "rope_theta",
]


def init_attention(cfg: ModelConfig, device) -> nn.ParameterDict:
    """Uninitialised projections (``init_attention_`` fills them):
    wq (d, H, D), wk/wv (d, KV, D), wo (H, D, d); q_norm/k_norm (D,)
    float32 with QK-norm."""
    dt = cfg.pdtype
    H, KV, D, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, cfg.d_model
    shapes = {"wq": (d, H, D), "wk": (d, KV, D), "wv": (d, KV, D), "wo": (H, D, d)}
    p = {n: nn.Parameter(torch.empty(s, dtype=dt, device=device), requires_grad=False)
         for n, s in shapes.items()}
    if cfg.qk_norm:
        for n in ("q_norm", "k_norm"):
            p[n] = nn.Parameter(torch.empty(D, dtype=torch.float32, device=device), requires_grad=False)
    return nn.ParameterDict(p)


@torch.no_grad()
def init_attention_(p: nn.ParameterDict, cfg: ModelConfig, generator: torch.Generator) -> None:
    d, H, D = cfg.d_model, cfg.num_heads, cfg.head_dim_
    for name in ("wq", "wk", "wv"):
        init_linear_(p[name], d, generator)
    init_linear_(p["wo"], H * D, generator)
    if cfg.qk_norm:
        p["q_norm"].zero_()
        p["k_norm"].zero_()


def _qk_norm(x, scale):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * (1.0 + scale)).to(x.dtype)


def rope_theta(cfg: ModelConfig, is_global: bool) -> float:
    """Global layers take ``rope_theta_global`` where a config sets it."""
    return cfg.rope_theta_global if (cfg.rope_theta_global and is_global) else cfg.rope_theta


def _project(params, x, cfg: ModelConfig):
    """x (B, S, d) → q (B, S, H, D), k, v (B, S, KV, D)."""
    B, S, d = x.shape
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = linear(x, params["wq"].reshape(d, H * D)).view(B, S, H, D)
    k = linear(x, params["wk"].reshape(d, KV * D)).view(B, S, KV, D)
    v = linear(x, params["wv"].reshape(d, KV * D)).view(B, S, KV, D)
    if cfg.qk_norm:
        q = _qk_norm(q, params["q_norm"])
        k = _qk_norm(k, params["k_norm"])
    return q, k, v


def _out(params, o, cfg: ModelConfig):
    """o (B, S, H, D) → (B, S, d)."""
    B, S, H, D = o.shape
    return linear(o.reshape(B, S, H * D), params["wo"].reshape(H * D, cfg.d_model))


def attention(params, x: torch.Tensor, cfg: ModelConfig, *, is_global: bool = True) -> torch.Tensor:
    """Causal self-attention (train / prefill) over positions 0…S−1:
    x (B, S, d) → (B, S, d). Local layers (``is_global`` False) see the
    last ``cfg.local_window`` keys."""
    B, S, _ = x.shape
    q, k, v = _project(params, x, cfg)
    theta = rope_theta(cfg, is_global)
    positions = torch.arange(S, device=x.device).expand(B, S)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    window = 0 if is_global else cfg.local_window
    o = flash_attention(q, k, v, causal=True, window=window, softcap=cfg.attn_logit_softcap)
    return _out(params, o, cfg)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, layers: int, dtype=None,
                  device=None) -> dict:
    dt = dtype or cfg.cdtype
    KV, D = cfg.num_kv_heads, cfg.head_dim_
    shape = (layers, batch, max_len, KV, D)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_attention(params, x_t: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: int, cfg: ModelConfig, *, is_global: bool = True, ring: bool = False):
    """One-token attention against this layer's cache (B, S, KV, D);
    writes the token's key and value in place and returns
    (out (B, 1, d), cache_k, cache_v).

    A linear cache takes the token at row ``pos`` and is read up to it
    (local layers within ``cfg.local_window``). A ring cache (``ring``,
    S = W) takes it at slot pos mod W; slot j then holds position
    pos − ((pos − j) mod W), valid iff j ≤ min(pos, W − 1), so the ring
    is read as a linear cache up to min(pos, W − 1) with no window."""
    B, W = x_t.shape[0], cache_k.shape[1]
    q, k_t, v_t = _project(params, x_t, cfg)
    theta = rope_theta(cfg, is_global)
    posb = torch.full((B, 1), pos, dtype=torch.int64, device=x_t.device)
    q = rope(q, posb, theta)[:, 0]
    k_t = rope(k_t, posb, theta)
    if ring:
        slot, read, window = pos % W, min(pos, W - 1), 0
    else:
        slot, read, window = pos, pos, 0 if is_global else cfg.local_window
    cache_k[:, slot] = k_t[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_t[:, 0].to(cache_v.dtype)
    o = decode_attention_kernel(q, cache_k, cache_v, read, window=window,
                                softcap=cfg.attn_logit_softcap)
    return _out(params, o[:, None], cfg), cache_k, cache_v
