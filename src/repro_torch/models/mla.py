"""Multi-head Latent Attention (DeepSeek-V2/V3), the port of
``repro.models.mla``.

Queries are (optionally, ``q_lora_rank``) low-rank compressed; keys and
values are jointly compressed into a ``kv_lora_rank`` latent plus one
rotary key shared by every head. Prefill takes the naive expansion:
queries and keys ``nope ‖ rope`` (dn + dr wide), values dv wide, scores
scaled by (dn + dr)^-0.5, through ``attention._attend`` — on the card
the flash kernel's (192, 128) instance, on the host the reference's
route (full scores up to ``CHUNKED_THRESHOLD``, the chunked path above
it). Decode caches only the latent ``c_kv`` and the rotary key
``k_rope``, written in place at the token's position, and takes the
absorbed form (W^UK folded into the query, W^UV into the output) in
stock PyTorch products, as the reference does: its 128 query heads over
one 576-wide key are no instance of the decode kernel, and the
reference reaches no Pallas kernel there either.

Left for a later slice (ROADMAP.md, queue A12.5): ``mla_decode_sharded``.
"""
from __future__ import annotations

import torch
from torch import nn

from .._device import warm_host_math
from .attention import _attend
from .common import ModelConfig
from .layers import init_linear_, linear, rms_norm, rope

__all__ = ["init_mla", "init_mla_", "mla_attention", "mla_decode", "init_mla_cache"]

NEG_INF = -2.0e38


def init_mla(cfg: ModelConfig, device) -> nn.ParameterDict:
    """Uninitialised parameters (``init_mla_`` fills them), in the
    reference's layouts: wq_a (d, rq), q_norm (rq,) float32 and
    wq_b (rq, H, dn + dr), or wq (d, H, dn + dr) without a query rank;
    wkv_a (d, rkv + dr), kv_norm (rkv,) float32, wkv_b (rkv, H, dn + dv),
    wo (H, dv, d)."""
    d, H = cfg.d_model, cfg.num_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt, f32 = cfg.pdtype, torch.float32
    if rq:
        shapes = {"wq_a": ((d, rq), dt), "q_norm": ((rq,), f32), "wq_b": ((rq, H, dn + dr), dt)}
    else:
        shapes = {"wq": ((d, H, dn + dr), dt)}
    shapes |= {"wkv_a": ((d, rkv + dr), dt), "kv_norm": ((rkv,), f32),
               "wkv_b": ((rkv, H, dn + dv), dt), "wo": ((H, dv, d), dt)}
    return nn.ParameterDict({
        n: nn.Parameter(torch.empty(s, dtype=t, device=device), requires_grad=False)
        for n, (s, t) in shapes.items()})


@torch.no_grad()
def init_mla_(p: nn.ParameterDict, cfg: ModelConfig, generator: torch.Generator) -> None:
    """The reference's scheme: each projection N(0, 1)/√fan_in, norms zero."""
    d = cfg.d_model
    fan_in = {"wq_a": d, "wq_b": cfg.q_lora_rank, "wq": d, "wkv_a": d, "wkv_b": cfg.kv_lora_rank,
              "wo": cfg.num_heads * cfg.v_head_dim}
    for name, w in p.items():
        if name in fan_in:
            init_linear_(w, fan_in[name], generator)
        else:
            w.zero_()


def _queries(params, x, cfg: ModelConfig, positions):
    """x (B, S, d) → qn (B, S, H, dn), rotated qr (B, S, H, dr)."""
    B, S, _ = x.shape
    H, dn = cfg.num_heads, cfg.qk_nope_head_dim
    dk = dn + cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        cq = rms_norm(linear(x, params["wq_a"]), params["q_norm"])
        q = linear(cq, params["wq_b"].reshape(cfg.q_lora_rank, H * dk))
    else:
        q = linear(x, params["wq"].reshape(cfg.d_model, H * dk))
    q = q.view(B, S, H, dk)
    return q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)


def _latents(params, x, cfg: ModelConfig, positions):
    """x (B, S, d) → c_kv (B, S, rkv) and the rotated key k_rope (B, S, dr)
    that every head shares."""
    rkv = cfg.kv_lora_rank
    kv_a = linear(x, params["wkv_a"])
    c_kv = rms_norm(kv_a[..., :rkv], params["kv_norm"])
    return c_kv, rope(kv_a[..., rkv:], positions, cfg.rope_theta)


def mla_attention(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Prefill (causal, positions 0…S−1): x (B, S, d) → (B, S, d) through
    the expanded keys and values. k = kn ‖ k_rope (the shared rotary key
    broadcast to every head, the reference's expansion) and v are two
    column ranges of one (B, S, H, dn + dr + dv) buffer, so that they
    share their strides as the flash kernel requires."""
    B, S, _ = x.shape
    H, rkv = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    positions = torch.arange(S, device=x.device).expand(B, S)
    qn, qr = _queries(params, x, cfg, positions)
    c_kv, k_rope = _latents(params, x, cfg, positions)
    kv = linear(c_kv, params["wkv_b"].reshape(rkv, H * (dn + dv))).view(B, S, H, dn + dv)
    kvb = kv.new_empty((B, S, H, dn + dr + dv))
    kvb[..., :dn] = kv[..., :dn]
    kvb[..., dn:dn + dr] = k_rope[:, :, None]
    kvb[..., dn + dr:] = kv[..., dn:]
    o = _attend(torch.cat([qn, qr], dim=-1), kvb[..., :dn + dr], kvb[..., dn + dr:], cfg,
                causal=True, window=0)
    return linear(o.reshape(B, S, H * dv), params["wo"].reshape(H * dv, cfg.d_model))


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, layers: int, dtype=None,
                   device=None) -> dict:
    """The compressed cache of ``layers`` layers: c_kv (layers, B, S, rkv)
    and k_rope (layers, B, S, dr)."""
    dt = dtype or cfg.cdtype
    return {"c_kv": torch.zeros((layers, batch, max_len, cfg.kv_lora_rank), dtype=dt, device=device),
            "k_rope": torch.zeros((layers, batch, max_len, cfg.qk_rope_head_dim), dtype=dt,
                                  device=device)}


def mla_decode(params, x_t: torch.Tensor, c_kv_cache: torch.Tensor, k_rope_cache: torch.Tensor,
               pos: int, cfg: ModelConfig):
    """One token in the absorbed form against this layer's caches
    c_kv (B, S, rkv) and k_rope (B, S, dr): writes the token's latent and
    rotary key at row ``pos`` in place, reads rows 0…pos, and returns
    (out (B, 1, d), c_kv_cache, k_rope_cache)."""
    B = x_t.shape[0]
    H, dn, dr, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    posb = torch.full((B, 1), pos, dtype=torch.int64, device=x_t.device)
    qn, qr = _queries(params, x_t, cfg, posb)                 # (B, 1, H, dn), (B, 1, H, dr)
    c_t, kr_t = _latents(params, x_t, cfg, posb)              # (B, 1, rkv), (B, 1, dr)
    c_kv_cache[:, pos] = c_t[:, 0].to(c_kv_cache.dtype)
    k_rope_cache[:, pos] = kr_t[:, 0].to(k_rope_cache.dtype)
    wkb = params["wkv_b"]                                      # (rkv, H, dn + dv)
    q_abs = torch.einsum("bqhc,rhc->bqhr", qn, wkb[..., :dn])  # W^UK absorbed into q
    s = (torch.einsum("bqhr,bkr->bhqk", q_abs, c_kv_cache)
         + torch.einsum("bqhc,bkc->bhqk", qr, k_rope_cache)).float() * ((dn + dr) ** -0.5)
    valid = torch.arange(c_kv_cache.shape[1], device=x_t.device) <= pos
    warm_host_math(s)
    p = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1).to(x_t.dtype)
    lat = torch.einsum("bhqk,bkr->bqhr", p, c_kv_cache)
    out = torch.einsum("bqhr,rhv->bqhv", lat, wkb[..., dn:])   # W^UV on the way out
    return (linear(out.reshape(B, 1, H * dv), params["wo"].reshape(H * dv, cfg.d_model)),
            c_kv_cache, k_rope_cache)
