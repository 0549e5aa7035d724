"""Single-token decode for every family, with its caches (the port of
``repro.models.decode``).

The caches keep the reference's layouts (``repro.models.decode.init_cache``)
and are updated in place: a decode step writes one row (or one state) per
layer and copies nothing else.

  dense   local layers: ring buffers of ``min(local_window, max_len)``
          (slot = pos mod W, keys stored pre-rotated); global layers a
          linear cache of ``max_len``
  vlm     self K/V (n_p, k − 1, …) + the image's cross K/V per cross layer
  moe     MLA's compressed latents only: ``{"moe": {"c_kv", "k_rope"}}``
          over the routed layers, ``"dense"`` the same over the first
          ``first_k_dense`` layers
  ssm     Mamba-2 conv tail and (H, P, N) float32 state per layer
  hybrid  RG-LRU ``h`` (float32) and conv tail per recurrent layer +
          a ring of ``min(local_window, max_len)`` per attention layer
  encdec  decoder self K/V + the encoder output's cross K/V per layer

Ring, linear and cross layers all go through the decode-attention kernel
(``attention.decode_attention``, ``attention.cross_decode``); MLA layers
take the absorbed form in stock products (``mla.mla_decode``). The
sharded decode paths are a later slice.
"""
from __future__ import annotations

from typing import Any

import torch

from .attention import cross_decode, cross_kv, decode_attention, init_kv_cache
from .common import ModelConfig
from .layers import mlp, rms_norm
from .lm import hybrid_periods
from .mla import init_mla_cache, mla_decode
from .rglru import init_rglru_state, rglru_decode
from .ssm import init_mamba_cache, mamba_decode

__all__ = ["init_cache", "decode_step"]


def _attn_decode_block(p, x_t, kc, vc, pos: int, cfg: ModelConfig, *, is_global: bool, ring: bool):
    h = rms_norm(x_t, p.ln1)
    a, kc, vc = decode_attention(p.attn, h, kc, vc, pos, cfg, is_global=is_global, ring=ring)
    x = x_t + a
    return x + mlp(p.mlp, rms_norm(x, p.ln2), cfg.mlp), kc, vc


def _cross_block(p, x_t, ck, cv, cfg: ModelConfig):
    h = cross_decode(p.attn, rms_norm(x_t, p.ln1), ck, cv, cfg)
    if p.xgate is not None:
        h = h * torch.tanh(p.xgate).to(h.dtype)
    x = x_t + h
    return x + mlp(p.mlp, rms_norm(x, p.ln2), cfg.mlp)


def _mla_block(p, x_t, c_kv, k_rope, pos: int, cfg: ModelConfig):
    a, _, _ = mla_decode(p.attn, rms_norm(x_t, p.ln1), c_kv, k_rope, pos, cfg)
    x = x_t + a
    return x + p.ffn(rms_norm(x, p.ln2), cfg)[0]


def _rec_block(p, x_t, h, conv, cfg: ModelConfig):
    y, _, _ = rglru_decode(p.mix, rms_norm(x_t, p.ln1), h, conv, cfg)
    x = x_t + y
    return x + mlp(p.mlp, rms_norm(x, p.ln2), cfg.mlp)


def _pattern_period(cfg: ModelConfig) -> tuple[int, str]:
    pat = cfg.layer_pattern
    if cfg.num_layers % len(pat):
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not whole periods of {pat!r}")
    return cfg.num_layers // len(pat), pat


def _uses_rings(cfg: ModelConfig) -> bool:
    return "L" in cfg.layer_pattern and cfg.local_window > 0


def _cross_cache(blocks, src: torch.Tensor, cfg: ModelConfig) -> dict:
    """Each cross layer's keys and values over ``src``, stacked: (n, B, N, KV, D)."""
    B, N, _ = src.shape
    shape = (len(blocks), B, N, cfg.num_kv_heads, cfg.head_dim_)
    cache = {"cross_k": src.new_empty(shape), "cross_v": src.new_empty(shape)}
    for i, b in enumerate(blocks):
        cache["cross_k"][i], cache["cross_v"][i] = cross_kv(b.attn, src, cfg)
    return cache


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_cache(lm, batch: int, max_len: int, *, image_embeds: torch.Tensor | None = None,
               audio_embeds: torch.Tensor | None = None) -> dict[str, Any]:
    """Caches on ``lm``'s device (zeros, but for the cross K/V that vlm
    computes from ``image_embeds`` (B, N, d) and encdec from the encoder's
    pass over ``audio_embeds``), in the reference's shapes and types."""
    cfg: ModelConfig = lm.cfg
    fam = cfg.family
    KV, D = cfg.num_kv_heads, cfg.head_dim_
    dev = lm.device
    z = lambda *s: torch.zeros(s, dtype=cfg.cdtype, device=dev)  # noqa: E731
    if fam == "dense":
        if _uses_rings(cfg):
            n_p, pat = _pattern_period(cfg)
            nl, ng = pat.count("L"), pat.count("G")
            W = min(cfg.local_window, max_len)
            return {
                "local_k": z(n_p, nl, batch, W, KV, D), "local_v": z(n_p, nl, batch, W, KV, D),
                "global_k": z(n_p, ng, batch, max_len, KV, D),
                "global_v": z(n_p, ng, batch, max_len, KV, D),
            }
        return init_kv_cache(cfg, batch, max_len, cfg.num_layers, device=dev)
    if fam == "vlm":
        if image_embeds is None:
            raise ValueError(f"{cfg.name}: vlm caches need image_embeds (the cross K/V)")
        k_every = cfg.cross_attn_every
        n_p = cfg.num_layers // k_every
        cache = {"k": z(n_p, k_every - 1, batch, max_len, KV, D),
                 "v": z(n_p, k_every - 1, batch, max_len, KV, D)}
        return cache | _cross_cache(lm.cross_blocks, image_embeds.to(cfg.cdtype), cfg)
    if fam == "moe":
        k = cfg.first_k_dense
        cache = {"moe": init_mla_cache(cfg, batch, max_len, cfg.num_layers - k, device=dev)}
        if k:
            cache["dense"] = init_mla_cache(cfg, batch, max_len, k, device=dev)
        return cache
    if fam == "ssm":
        return init_mamba_cache(cfg, batch, cfg.num_layers, device=dev)
    if fam == "hybrid":
        n_p, rem = hybrid_periods(cfg)
        st = init_rglru_state(cfg, batch, n_p * 2, device=dev)
        W = min(cfg.local_window, max_len)
        cache = {
            "h": st["h"].reshape(n_p, 2, batch, -1),
            "conv": st["conv"].reshape(n_p, 2, batch, 3, -1),
            "ring_k": z(n_p, batch, W, KV, D), "ring_v": z(n_p, batch, W, KV, D),
        }
        if rem:
            ex = init_rglru_state(cfg, batch, rem, device=dev)
            cache["extra_h"], cache["extra_conv"] = ex["h"], ex["conv"]
        return cache
    if fam == "encdec":
        if audio_embeds is None:
            raise ValueError(f"{cfg.name}: encdec caches need audio_embeds (the encoder's input)")
        cache = init_kv_cache(cfg, batch, max_len, cfg.num_layers, device=dev)
        return cache | _cross_cache(lm.dec_cross, lm.encode(audio_embeds), cfg)
    raise ValueError(fam)


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_step(lm, tokens_t: torch.Tensor, cache: dict, pos: int):
    """tokens_t (B, 1) integer; pos an int → (logits (B, 1, V) float32,
    cache), the cache updated in place. Layers run in the reference's
    order: with local dense layers period by period, locals before
    globals within a period (the natural order for the contiguous L…G
    patterns of the dense configs); the moe family's dense layers before
    its routed ones; the hybrid's two recurrent blocks before its
    attention block in each period, then the trailing ones."""
    cfg: ModelConfig = lm.cfg
    fam = cfg.family
    pos = int(pos)
    x = lm._embed(tokens_t)
    if fam == "dense":
        blocks = lm.blocks
        if _uses_rings(cfg):
            n_p, pat = _pattern_period(cfg)
            period = len(pat)
            li = [i for i, c in enumerate(pat) if c == "L"]
            gi = [i for i, c in enumerate(pat) if c == "G"]
            for p in range(n_p):
                for n, i in enumerate(li):
                    x, _, _ = _attn_decode_block(
                        blocks[p * period + i], x, cache["local_k"][p, n], cache["local_v"][p, n],
                        pos, cfg, is_global=False, ring=True)
                for n, i in enumerate(gi):
                    x, _, _ = _attn_decode_block(
                        blocks[p * period + i], x, cache["global_k"][p, n], cache["global_v"][p, n],
                        pos, cfg, is_global=True, ring=False)
        else:
            for i, blk in enumerate(blocks):
                x, _, _ = _attn_decode_block(blk, x, cache["k"][i], cache["v"][i], pos, cfg,
                                             is_global=True, ring=False)
    elif fam == "vlm":
        for p, (selfs, cross) in enumerate(zip(lm.self_blocks, lm.cross_blocks)):
            for j, blk in enumerate(selfs):
                x, _, _ = _attn_decode_block(blk, x, cache["k"][p, j], cache["v"][p, j], pos, cfg,
                                             is_global=True, ring=False)
            x = _cross_block(cross, x, cache["cross_k"][p], cache["cross_v"][p], cfg)
    elif fam == "moe":
        for part, blocks in (("dense", getattr(lm, "dense_blocks", ())), ("moe", lm.moe_blocks)):
            for i, blk in enumerate(blocks):
                x = _mla_block(blk, x, cache[part]["c_kv"][i], cache[part]["k_rope"][i], pos, cfg)
    elif fam == "ssm":
        for i, blk in enumerate(lm.blocks):
            y, _, _ = mamba_decode(blk.mix, rms_norm(x, blk.ln), cache["conv"][i], cache["state"][i], cfg)
            x = x + y
    elif fam == "hybrid":
        for p, (recs, attn) in enumerate(zip(lm.rec_blocks, lm.attn_blocks)):
            for j, blk in enumerate(recs):
                x = _rec_block(blk, x, cache["h"][p, j], cache["conv"][p, j], cfg)
            x, _, _ = _attn_decode_block(attn, x, cache["ring_k"][p], cache["ring_v"][p], pos, cfg,
                                         is_global=False, ring=True)
        for i, blk in enumerate(getattr(lm, "extra_rec", ())):
            x = _rec_block(blk, x, cache["extra_h"][i], cache["extra_conv"][i], cfg)
    elif fam == "encdec":
        for i, (self_blk, cross) in enumerate(zip(lm.dec_self, lm.dec_cross)):
            x, _, _ = _attn_decode_block(self_blk, x, cache["k"][i], cache["v"][i], pos, cfg,
                                         is_global=True, ring=False)
            x = _cross_block(cross, x, cache["cross_k"][i], cache["cross_v"][i], cfg)
    else:
        raise ValueError(fam)
    return lm._logits(x), cache
