"""Single-token decode for the dense family, with its caches.

Local-attention layers use **ring-buffer** K/V caches of size
``min(local_window, max_len)`` (slot = pos mod W, keys stored
pre-rotated); global layers a linear cache of ``max_len``. The caches
keep the reference's layout (``repro.models.decode.init_cache``) and
are updated in place: a decode step writes one row per layer and
copies nothing else. Ring layers go through the same decode-attention
kernel as linear ones (``attention.decode_attention(..., ring=True)``).

Other families (vlm, moe/MLA, ssm, hybrid, encdec) are later slices
(ROADMAP.md); so are the sharded decode paths.
"""
from __future__ import annotations

from typing import Any

import torch

from .attention import decode_attention, init_kv_cache
from .common import ModelConfig
from .layers import mlp, rms_norm

__all__ = ["init_cache", "decode_step"]


def _attn_decode_block(p, x_t, kc, vc, pos: int, cfg: ModelConfig, *, is_global: bool, ring: bool):
    h = rms_norm(x_t, p.ln1)
    a, kc, vc = decode_attention(p.attn, h, kc, vc, pos, cfg, is_global=is_global, ring=ring)
    x = x_t + a
    return x + mlp(p.mlp, rms_norm(x, p.ln2), cfg.mlp), kc, vc


def _pattern_period(cfg: ModelConfig) -> tuple[int, str]:
    pat = cfg.layer_pattern
    if cfg.num_layers % len(pat):
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not whole periods of {pat!r}")
    return cfg.num_layers // len(pat), pat


def _uses_rings(cfg: ModelConfig) -> bool:
    return "L" in cfg.layer_pattern and cfg.local_window > 0


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------

def init_cache(lm, batch: int, max_len: int) -> dict[str, Any]:
    """Zeroed caches on ``lm``'s device, in the compute type: with local
    layers, ``local_k/v`` (n_p, nL, B, min(W, max_len), KV, D) and
    ``global_k/v`` (n_p, nG, B, max_len, KV, D); else ``k/v``
    (L, B, max_len, KV, D)."""
    cfg: ModelConfig = lm.cfg
    if cfg.family != "dense":
        raise NotImplementedError(f"decode caches for the {cfg.family} family are not ported "
                                  "yet (ROADMAP.md, queue A12)")
    KV, D = cfg.num_kv_heads, cfg.head_dim_
    dev = lm.device
    if _uses_rings(cfg):
        n_p, pat = _pattern_period(cfg)
        nl, ng = pat.count("L"), pat.count("G")
        W = min(cfg.local_window, max_len)
        z = lambda *s: torch.zeros(s, dtype=cfg.cdtype, device=dev)  # noqa: E731
        return {
            "local_k": z(n_p, nl, batch, W, KV, D), "local_v": z(n_p, nl, batch, W, KV, D),
            "global_k": z(n_p, ng, batch, max_len, KV, D),
            "global_v": z(n_p, ng, batch, max_len, KV, D),
        }
    return init_kv_cache(cfg, batch, max_len, cfg.num_layers, device=dev)


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_step(lm, tokens_t: torch.Tensor, cache: dict, pos: int):
    """tokens_t (B, 1) integer; pos an int → (logits (B, 1, V) float32,
    cache), the cache updated in place.

    With local layers the layers run period by period, locals before
    globals within a period, as the reference's nested scans do (the
    natural order for the contiguous L…G patterns of the dense configs)."""
    cfg: ModelConfig = lm.cfg
    if cfg.family != "dense":
        raise NotImplementedError(f"decode for the {cfg.family} family is not ported yet "
                                  "(ROADMAP.md, queue A12)")
    pos = int(pos)
    x = lm._embed(tokens_t)
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
    return lm._logits(x), cache
