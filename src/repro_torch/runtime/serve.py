"""The serve step: one decode step against a persistent KV cache (the
port of ``repro.runtime.serve``), on one device or on each rank of a mesh
placed over a process group.

With a mesh, ``build_serve_step`` returns the per-rank step and the
counterpart of the reference's ``(params_sh, cache_sh, tok_sh, pos_sh)``:
the specs by which this rank's blocks are cut, the reference's own
(``runtime.sharding.param_specs(mesh, lm, serve=True)`` and its
``cache_specs``, ``models.decode.param_blocks`` and ``cache_blocks``).
The reference hands XLA the global arrays and their shardings; here every
rank holds exactly its blocks (``local_lm``, ``runtime.sharding.local_block``)
and runs the sharded decode on them where they lie (``models.decode``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..launch.mesh import placed
from ..models import LM, decode
from ..models.attention import _decode_bspec
from .pspec import logical_axis_rules
from .sharding import local_block

__all__ = ["build_serve_step", "abstract_cache", "local_lm"]


def _meta_lm(lm: LM) -> LM:
    return lm if lm.device.type == "meta" else LM(lm.cfg, device="meta")


def abstract_cache(lm: LM, batch: int, max_len: int, *, frames: int | None = None) -> dict:
    """``decode.init_cache``'s tree on the ``meta`` device (shapes and
    types, no storage), built from a ``meta`` copy of ``lm``. The vlm
    family's image embeddings come in as a meta (batch, num_image_tokens,
    d) tensor and encdec's audio frames as a meta (batch, frames, d) one,
    frames max_len by default, as the reference's stub frontends give
    them; their cross caches run
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
        kw["audio_embeds"] = torch.empty((batch, frames or max_len, cfg.d_model), dtype=cfg.cdtype, device="meta")
    with logical_axis_rules(None):
        return decode.init_cache(meta, batch, max_len, **kw)


def local_lm(lm: LM, specs: dict, mesh, *, copy: bool = True) -> LM:
    """An ``LM`` that holds this rank's block of each parameter of the
    whole ``lm`` (``specs``): a cut parameter in storage of its own (with
    ``copy``, so that the whole one can go) or a view of ``lm``'s, a whole
    one shared with ``lm``. Built on ``meta`` and filled, so no full copy
    is made."""
    local = LM(lm.cfg, device="meta")
    for name, p in lm.named_parameters():
        spec = specs[name]
        t = p if all(e is None for e in spec) else local_block(p, spec, mesh)
        if copy and t is not p:
            t = t.clone()
        owner, _, leaf = name.rpartition(".")
        setattr(local.get_submodule(owner), leaf, nn.Parameter(t, requires_grad=False))
    return local


def build_serve_step(lm: LM, batch: int, max_len: int, *, mesh=None, frames: int | None = None):
    """Without a mesh: (serve_step, cache_abs) for ``lm`` on its own device,
    ``serve_step(tokens_t, cache, pos) → (logits (B, 1, V) float32, cache)``
    being ``decode.decode_step`` (the cache updated in place) and
    ``cache_abs`` ``abstract_cache(lm, batch, max_len, frames=frames)``.

    With a mesh placed over a process group (``launch.mesh.make_mesh``;
    every rank calls this with the whole ``lm``): (serve_step, (params_sh,
    cache_sh, tok_sh, pos_sh), cache_abs). ``serve_step`` runs the sharded
    decode step under the mesh on this rank's blocks: tokens_t its rows of
    the global batch (``tok_sh``), the cache its blocks (``cache_sh``,
    ``decode.cache_blocks``: the reference's ``cache_specs`` of
    ``cache_abs``; ``decode.init_cache`` under
    ``runtime.pspec.logical_axis_rules(mesh)`` allocates them, whisper's
    over ``frames`` audio frames) → the logits of its rows. ``params_sh``
    maps every parameter name to the spec of the block the step holds, the
    reference's ``param_specs(mesh, lm, serve=True)``
    (``decode.param_blocks``), cut from ``lm`` once, here (``serve_step.lm``
    is the rank's model that holds them); ``pos_sh`` is () (replicated);
    ``cache_abs`` is the global cache tree on ``meta``."""
    cache_abs = abstract_cache(lm, batch, max_len, frames=frames)
    if mesh is None:
        def serve_step(tokens_t: torch.Tensor, cache: dict, pos: int):
            return decode.decode_step(lm, tokens_t, cache, pos)

        return serve_step, cache_abs
    if not placed(mesh):
        raise ValueError("build_serve_step: the mesh must be placed over a process group (launch.mesh.make_mesh)")
    with logical_axis_rules(mesh):
        params_sh = decode.param_blocks(lm)
        cache_sh = decode.cache_blocks(lm, batch, max_len, frames=frames)
    tok_sh, pos_sh = (_decode_bspec(mesh, batch), None), ()
    rank_lm = local_lm(lm, params_sh, mesh)
    layers = decode.layer_specs(params_sh)

    def sharded_step(tokens_t: torch.Tensor, cache: dict, pos: int):
        with logical_axis_rules(mesh):
            return decode.decode_step(rank_lm, tokens_t, cache, pos, batch=batch, specs=params_sh,
                                      cache_specs=cache_sh, layers=layers)

    sharded_step.lm = rank_lm
    return sharded_step, (params_sh, cache_sh, tok_sh, pos_sh), cache_abs
