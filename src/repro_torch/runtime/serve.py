"""The serve step: one decode step against a persistent KV cache (the
port of ``repro.runtime.serve``), on one device or on each rank of a mesh
placed over a process group.

With a mesh, ``build_serve_step`` returns the per-rank step and the
counterpart of the reference's ``(params_sh, cache_sh, tok_sh, pos_sh)``:
the specs by which this rank's blocks are cut. The reference hands XLA
the global arrays and their shardings; here every rank holds its blocks
(``runtime.sharding.local_block``) and runs the sharded decode on them
(``models.decode``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..launch.mesh import placed
from ..models import LM, decode
from ..models.attention import _decode_bspec
from .pspec import logical_axis_rules
from .sharding import local_block

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
    attention kernels' shape-only route. The tree is the global one also
    where a mesh placed over a process group is current."""
    cfg = lm.cfg
    meta = _meta_lm(lm)
    kw = {}
    if cfg.family == "vlm":
        kw["image_embeds"] = torch.empty((batch, cfg.num_image_tokens, cfg.d_model), dtype=cfg.cdtype,
                                         device="meta")
    if cfg.family == "encdec":
        kw["audio_embeds"] = torch.empty((batch, max_len, cfg.d_model), dtype=cfg.cdtype, device="meta")
    with logical_axis_rules(None):
        return decode.init_cache(meta, batch, max_len, **kw)


def _local_lm(lm: LM, specs: dict, mesh) -> LM:
    """A copy of ``lm`` that holds this rank's block of each parameter
    (``specs``): a cut parameter in storage of its own, a whole one shared
    with ``lm``. Built on ``meta`` and filled, so no full copy is made."""
    local = LM(lm.cfg, device="meta")
    for name, p in lm.named_parameters():
        spec = specs[name]
        t = p if all(e is None for e in spec) else local_block(p, spec, mesh).clone()
        owner, _, leaf = name.rpartition(".")
        setattr(local.get_submodule(owner), leaf, nn.Parameter(t, requires_grad=False))
    return local


def build_serve_step(lm: LM, batch: int, max_len: int, *, mesh=None):
    """Without a mesh: (serve_step, cache_abs) for ``lm`` on its own device,
    ``serve_step(tokens_t, cache, pos) → (logits (B, 1, V) float32, cache)``
    being ``decode.decode_step`` (the cache updated in place) and
    ``cache_abs`` ``abstract_cache(lm, batch, max_len)``.

    With a mesh placed over a process group (``launch.mesh.make_mesh``;
    every rank calls this with the whole ``lm``): (serve_step, (params_sh,
    cache_sh, tok_sh, pos_sh), cache_abs). ``serve_step`` runs the sharded
    decode step under the mesh on this rank's blocks: tokens_t its rows of
    the global batch (``tok_sh``), the cache its blocks (``cache_sh``;
    ``decode.init_cache`` under ``runtime.pspec.logical_axis_rules(mesh)``
    allocates them) → the logits of its rows. ``params_sh`` maps every
    parameter name to the spec of the block the step holds
    (``decode.param_blocks``, cut from ``lm`` once, here: the embedding
    and the unembedding as the reference's ``param_specs(..., serve=True)``
    cuts them); ``pos_sh`` is () (replicated); ``cache_abs`` is the global
    cache tree on ``meta``."""
    if mesh is None:
        def serve_step(tokens_t: torch.Tensor, cache: dict, pos: int):
            return decode.decode_step(lm, tokens_t, cache, pos)

        return serve_step, abstract_cache(lm, batch, max_len)
    if not placed(mesh):
        raise ValueError("build_serve_step: the mesh must be placed over a process group (launch.mesh.make_mesh)")
    with logical_axis_rules(mesh):
        params_sh = decode.param_blocks(lm, batch, max_len)
        cache_sh = decode.cache_blocks(lm, batch, max_len)
    tok_sh, pos_sh = (_decode_bspec(mesh, batch), None), ()
    rank_lm = _local_lm(lm, params_sh, mesh)

    def sharded_step(tokens_t: torch.Tensor, cache: dict, pos: int):
        with logical_axis_rules(mesh):
            return decode.decode_step(rank_lm, tokens_t, cache, pos, batch=batch, max_len=max_len, specs=params_sh)

    return sharded_step, (params_sh, cache_sh, tok_sh, pos_sh), abstract_cache(lm, batch, max_len)
