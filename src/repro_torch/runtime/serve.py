"""The serve step on one device: one decode step against a persistent KV
cache (the single-device half of ``repro.runtime.serve``).

``build_serve_step`` takes no mesh and returns no shardings: the
reference's ``(params_sh, cache_sh, tok_sh, pos_sh)`` tuple comes with the
sharded decode paths (ROADMAP.md, queue A12.5). ``runtime.sharding``
gives the specs those shardings would take, as rules on mesh shapes.
"""
from __future__ import annotations

import torch

from ..models import LM, decode

__all__ = ["build_serve_step", "abstract_cache"]


def _meta_lm(lm: LM) -> LM:
    return lm if lm.device.type == "meta" else LM(lm.cfg, device="meta")


def abstract_cache(lm: LM, batch: int, max_len: int) -> dict:
    """``decode.init_cache``'s tree on the ``meta`` device (shapes and
    types, no storage), built from a ``meta`` copy of ``lm``. The vlm
    family's image embeddings come in as a meta (batch, num_image_tokens,
    d) tensor and encdec's audio frames as a meta (batch, max_len, d) one,
    as the reference's stub frontends give them; their cross caches run
    the cross projections (and whisper's encoder) on ``meta``, through the
    attention kernels' shape-only route."""
    cfg = lm.cfg
    meta = _meta_lm(lm)
    kw = {}
    if cfg.family == "vlm":
        kw["image_embeds"] = torch.empty((batch, cfg.num_image_tokens, cfg.d_model), dtype=cfg.cdtype,
                                         device="meta")
    if cfg.family == "encdec":
        kw["audio_embeds"] = torch.empty((batch, max_len, cfg.d_model), dtype=cfg.cdtype, device="meta")
    return decode.init_cache(meta, batch, max_len, **kw)


def build_serve_step(lm: LM, batch: int, max_len: int):
    """(serve_step, cache_abs) for ``lm`` on its own device, one device:
    ``serve_step(tokens_t, cache, pos) → (logits (B, 1, V) float32, cache)``
    is ``decode.decode_step`` (the cache updated in place); ``cache_abs`` is
    ``abstract_cache(lm, batch, max_len)``. No mesh argument and no
    sharding tuple: those come with the sharded decode paths (A12.5)."""

    def serve_step(tokens_t: torch.Tensor, cache: dict, pos: int):
        return decode.decode_step(lm, tokens_t, cache, pos)

    return serve_step, abstract_cache(lm, batch, max_len)
