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
take the absorbed form in stock products (``mla.mla_decode``).

Under a mesh placed over a process group (``launch.mesh.make_mesh``, the
current mesh of ``runtime.pspec.logical_axis_rules``) each rank holds the
blocks of the reference's serve step and nothing more: every parameter
cut by ``runtime.sharding.param_specs(mesh, lm, serve=True)``
(``param_blocks``) and every cache by ``runtime.sharding.cache_spec``
(``cache_blocks``: rows over the batch axes, the longest dimension that
divides over 'model'; where the reference's rule would take a stacked
layer axis as long as the batch for the batch, the batch dimension
itself, ROADMAP C13). It runs the step on its rows of the global batch
(``attention._decode_bspec``) and each layer on its blocks where they
lie, so that only one-token activations, log-sum-exps and partial sums
cross ranks, but for the routed experts where the gather dispatch
gathers a held block over 'data' (an expert count that does not divide
over the EP axes, deepseek-v2's 160 at 16 × 16; ROADMAP Next 3):

  attention  ``attention.decode_attention_sharded``: the projections
             weight-stationary, the cache, linear or a ring, read where
             the rules cut it: along S (the decode kernel's key-range
             entry and the ranks' (out, lse) pairs combined, whatever S/m
             is), along its rows (the kernel on the rank's rows, the
             outputs gathered) or along D (float32 partial scores summed)
  cross      ``attention.cross_decode_sharded``: the same without a write,
             every key visible, N in place of S
  MLP        ``attention.decode_mlp_sharded`` (the shared experts too)
  MLA        ``mla.mla_decode_sharded`` on latent caches cut along S,
             along their rows, or c_kv along its latent dimension with
             k_rope along S, its rows or its rope dimension
  experts    ``moe.moe_gather_sharded``, the gather dispatch of the
             sharded batch on the held experts (the router's logits
             weight-stationary where its d is cut)
  RG-LRU     ``rglru.rglru_decode_sharded``, channel-parallel on the
             rank's width block of ``h`` and ``conv``, or on its rows of
             them
  Mamba-2    ``ssm.mamba_decode_sharded`` on the rank's blocks of ``conv``
             and ``state``

A body reads the held blocks through views where its own specs
(``decode_attention_specs``, ``decode_mlp_specs``, ``mla_decode_specs``)
cut more than the rules (d over 'data' under TP-only serving). Which
layouts the bodies read is one table, ``READS`` (``layout`` gives a
layer's, ``reads`` decides, ``layouts`` lists a step's): every layout the
rules give over the catalog is there, and a layer laid out otherwise
raises, naming the layer and its blocks. Where the rules cut the RG-LRU's
or Mamba-2's conv cache along its rows and its filter by channels, the
filter's blocks (conv width × channels/m) are gathered over 'model', the
one parameter block a decode body moves. Where ``REPRO_SHARDED_DECODE=0`` turns
the sharded bodies off, every layer gathers its blocks at use, runs the
one-device layer on the rank's rows and writes its cache blocks back
(``gathered_layer.calls`` counts them). The embedding and the
unembedding stay cut as the rules cut them: the lookup is
vocab-parallel (``layers.vocab_embed``), the logits each rank's (…, V/m)
block gathered along V over 'model', and where the width is cut too both
run weight-stationary, as ``attention._psum_proj`` does. ``init_cache``
allocates only the rank's block of each cache; a cross cache is
projected on the rank's block alone, and whisper's encoder runs as the
sharded prefill runs it (``attention.attention_sharded``, non-causal,
and ``attention.mlp_sharded`` on the rank's blocks).
"""
from __future__ import annotations

import collections
import math
from typing import Any

import torch

from .. import tracing
from ..launch.mesh import all_gather, gather_dims, placed, spec_axes
from .attention import (_batch_row_start, _decode_bspec, _gather_batch, _heads, _psum_proj, _rows, col_proj,
                        cross_decode, cross_decode_sharded, current_mesh, decode_attention, decode_attention_sharded,
                        decode_attention_specs, decode_mlp_sharded, decode_mlp_specs, sharded_decode_on)
from .common import ModelConfig
from .layers import mlp, rms_norm
from .lm import Placement, TableRows, hybrid_periods
from .mla import init_mla_cache, mla_decode, mla_decode_sharded, mla_decode_specs
from .moe import moe_gather_sharded
from .rglru import init_rglru_state, rglru_decode, rglru_decode_sharded
from .ssm import init_mamba_cache, mamba_decode, mamba_decode_sharded

__all__ = ["init_cache", "decode_step", "cache_blocks", "param_blocks", "layer_specs", "gathered_layer", "layouts",
           "reads"]


def _pattern_period(cfg: ModelConfig) -> tuple[int, str]:
    pat = cfg.layer_pattern
    if cfg.num_layers % len(pat):
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not whole periods of {pat!r}")
    return cfg.num_layers // len(pat), pat


def _uses_rings(cfg: ModelConfig) -> bool:
    return "L" in cfg.layer_pattern and cfg.local_window > 0


def _placed_mesh():
    """The current mesh if it is placed over a process group, else None."""
    mesh = current_mesh()
    return mesh if placed(mesh) else None


def _model_dim(spec: tuple, mesh) -> int | None:
    """The dimension that ``spec`` cuts over 'model' (None: none, or a
    'model' axis of one rank)."""
    if mesh.get("model", 1) == 1:
        return None
    return next((i for i, e in enumerate(spec) if "model" in spec_axes(e)), None)


def _view(t: torch.Tensor, held: tuple, want: tuple, mesh) -> torch.Tensor:
    """The block under ``want`` of ``t``, the rank's block under ``held``,
    as a view: a body's spec may cut a dimension the rules hold whole (d
    over 'data' under TP-only serving), never the other way round."""
    for dim, (h, w) in enumerate(zip(held, want)):
        ha = tuple(a for a in spec_axes(h) if mesh.get(a, 1) > 1)
        wa = tuple(a for a in spec_axes(w) if mesh.get(a, 1) > 1)
        if ha == wa:
            continue
        if ha:
            raise ValueError(f"a block held under {held} is cut where the body reads {want}")
        idx, n = 0, 1
        for a in wa:
            idx, n = idx * mesh[a] + mesh.coords[a], n * mesh[a]
        size = t.shape[dim] // n
        t = t.narrow(dim, idx * size, size)
    return t


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _attn_block(ops, p, prefix: str, x, kc, vc, pos: int, cfg: ModelConfig, cut, *, is_global: bool, ring: bool):
    with tracing.span("decode.block", layer=prefix, kind="attn"):
        with tracing.span("decode.attn"):
            h = ops.attention(p.attn, f"{prefix}.attn", rms_norm(x, p.ln1), kc, vc, pos, cfg, cut,
                              is_global=is_global, ring=ring)
        x = x + h
        with tracing.span("decode.mlp"):
            return x + ops.mlp(p.mlp, f"{prefix}.mlp", rms_norm(x, p.ln2), cfg)


def _cross_block(ops, p, prefix: str, x, ck, cv, cfg: ModelConfig, cut):
    h = ops.cross(p.attn, f"{prefix}.attn", rms_norm(x, p.ln1), ck, cv, cfg, cut)
    if p.xgate is not None:
        h = h * torch.tanh(p.xgate).to(h.dtype)
    x = x + h
    return x + ops.mlp(p.mlp, f"{prefix}.mlp", rms_norm(x, p.ln2), cfg)


def _mla_block(ops, p, prefix: str, x, c_kv, k_rope, pos: int, cfg: ModelConfig, cuts):
    with tracing.span("decode.block", layer=prefix, kind="mla"):
        with tracing.span("decode.mla"):
            x = x + ops.mla(p.attn, f"{prefix}.attn", rms_norm(x, p.ln1), c_kv, k_rope, pos, cfg, cuts)
        with tracing.span("decode.mlp" if p.moe is None else "decode.moe"):
            return x + ops.ffn(p, prefix, rms_norm(x, p.ln2), cfg)


def _rec_block(ops, p, prefix: str, x, h, conv, cfg: ModelConfig, cuts):
    x = x + ops.rglru(p.mix, f"{prefix}.mix", rms_norm(x, p.ln1), h, conv, cfg, cuts)
    return x + ops.mlp(p.mlp, f"{prefix}.mlp", rms_norm(x, p.ln2), cfg)


class _OneDevice:
    """The step's layers on one device (no placed mesh): the reference's."""

    def attention(self, p, prefix, h, kc, vc, pos, cfg, cut, *, is_global, ring):
        return decode_attention(p, h, kc, vc, pos, cfg, is_global=is_global, ring=ring)[0]

    def cross(self, p, prefix, h, ck, cv, cfg, cut):
        return cross_decode(p, h, ck, cv, cfg)

    def mlp(self, p, prefix, h, cfg):
        return mlp(p, h, cfg.mlp)

    def mla(self, p, prefix, h, c_kv, k_rope, pos, cfg, cuts):
        return mla_decode(p, h, c_kv, k_rope, pos, cfg)[0]

    def ffn(self, blk, prefix, h, cfg):
        return blk.ffn(h, cfg)[0]

    def rglru(self, p, prefix, h, hc, conv, cfg, cuts):
        return rglru_decode(p, h, hc, conv, cfg)[0]

    def mamba(self, p, prefix, h, conv, state, cfg, cuts):
        return mamba_decode(p, h, conv, state, cfg)[0]


def gathered_layer(fn, params, specs: dict, caches, mesh):
    """``fn(whole params, *whole caches)`` on this rank's rows: each
    parameter's blocks (``specs``) gathered over every axis, each cache
    (block, the dimension it is cut over 'model' along or None) gathered
    over 'model', and the caches' blocks of the updated wholes written
    back. The decode's baseline, where ``REPRO_SHARDED_DECODE=0`` turns
    the sharded bodies off; ``.calls`` counts its layers."""
    gathered_layer.calls += 1
    whole = {n: gather_dims(t, specs[n], mesh) for n, t in params.items() if t is not None}
    full = [c if cut is None else all_gather(c, "model", mesh, dim=cut) for c, cut in caches]
    out = fn(whole, *full)
    r = mesh.coords.get("model", 0)
    for (c, cut), f in zip(caches, full):
        if cut is not None:
            c.copy_(f.narrow(cut, r * c.shape[cut], c.shape[cut]))
    return out


gathered_layer.calls = 0   # layers that gathered their blocks at use, this process


def layer_specs(specs: dict) -> dict:
    """``specs`` (parameter name → spec) grouped under every dotted prefix
    of the names: prefix → {the rest of the name → spec}, each layer's
    parameters' specs by the names its own module gives them."""
    out: dict = {}
    for name, spec in specs.items():
        for i, c in enumerate(name):
            if c == ".":
                out.setdefault(name[:i], {})[name[i + 1:]] = spec
    return out


# The layouts the sharded bodies read: a layer kind → its layouts, each the
# dimensions along which the layer's blocks are cut over 'model' (None: not
# cut, or a 'model' axis of one rank), as ``layout`` gives them. Every layout
# that ``runtime.sharding``'s rules give over the catalog is here
# (tests/test_torch_decode_layouts.py sweeps them); any other raises.
_CACHE_CUTS = {(None,), (0,), (1,), (3,)}          # whole, its rows, S (N), D
READS = {
    "self": _CACHE_CUTS,                            # a self-attention cache, linear or a ring
    "cross": _CACHE_CUTS,                           # a cross cache
    # (c_kv's, k_rope's): both whole, along the rows or along S; c_kv along its latent dimension with
    # k_rope along the rows, S or its rope dimension
    "mla": {(None, None), (0, 0), (1, 1), (2, 0), (2, 1), (2, 2)},
    # (w_x's, h's, conv's): nothing cut; the gates' columns with h and conv by channels or by rows
    "rglru": {(None, None, None), (1, 1, 2), (1, 0, 0)},
    # (conv_w's, conv's, state's): the conv cache whole or by rows with the filter whole, by channels or by
    # rows with the filter cut by channels; the state whole or by rows, heads or its N-block
    "mamba": {(f, c, st) for f, c in ((None, None), (None, 0), (1, 2), (1, 0)) for st in (None, 0, 1, 3)},
}
# the parameter whose cut decides a layer's body, after which its caches' cuts follow
_LEAD_PARAM = {"rglru": "w_x", "mamba": "conv_w"}


def layout(kind: str, cuts: tuple, held: dict, mesh) -> tuple:
    """A layer's layout: ``cuts``, its caches' dimensions cut over 'model',
    after the cut of the parameter that decides its body (``_LEAD_PARAM``)
    among ``held``, the layer's parameters' specs."""
    name = _LEAD_PARAM.get(kind)
    return tuple(cuts) if name is None else (_model_dim(held[name], mesh), *cuts)


def reads(kind: str, lay: tuple) -> bool:
    """Whether a sharded body reads a layer of ``kind`` ('self', 'cross',
    'mla', 'rglru', 'mamba') laid out as ``lay`` (``layout``)."""
    return tuple(lay) in READS[kind]


def cache_cuts(cfg: ModelConfig, cache_specs: dict, mesh) -> dict:
    """Each group of layers of ``cfg``'s decode step → the dimensions along
    which a layer's blocks of its caches are cut over 'model' (None: not
    cut), by the caches' specs ``cache_specs`` (``cache_blocks``): 'local'
    and 'global' (dense layers with rings) or 'self', and 'cross' (the
    key's cache), 'dense' and 'moe' (MLA: c_kv's, k_rope's), 'mamba'
    (conv's, state's), 'rec' and 'extra' (the RG-LRU's h's, conv's),
    'ring'."""
    def cut(name: str):
        spec = cache_specs
        for key in name.split("/"):
            spec = spec[key]
        return _model_dim(spec[_lead_axes(cfg, name.split("/")[-1]):], mesh)

    fam = cfg.family
    if fam == "dense":
        if _uses_rings(cfg):
            return {"local": (cut("local_k"),), "global": (cut("global_k"),)}
        return {"self": (cut("k"),)}
    if fam in ("vlm", "encdec"):
        return {"self": (cut("k"),), "cross": (cut("cross_k"),)}
    if fam == "moe":
        return {part: (cut(f"{part}/c_kv"), cut(f"{part}/k_rope")) for part in cache_specs}
    if fam == "ssm":
        return {"mamba": (cut("conv"), cut("state"))}
    if fam == "hybrid":
        out = {"rec": (cut("h"), cut("conv")), "ring": (cut("ring_k"),)}
        if "extra_h" in cache_specs:
            out["extra"] = (cut("extra_h"), cut("extra_conv"))
        return out
    raise ValueError(fam)


# each group of ``cache_cuts`` → (its layers' kind, the prefix of its first layer's parameters)
_GROUPS = {"local": ("self", None), "global": ("self", None), "self": ("self", None), "ring": ("self", None),
           "cross": ("cross", None), "dense": ("mla", None), "moe": ("mla", None), "mamba": ("mamba", "blocks.0.mix"),
           "rec": ("rglru", "rec_blocks.0.0.mix"), "extra": ("rglru", "extra_rec.0.mix")}


def layouts(cfg: ModelConfig, cache_specs: dict, layers: dict, mesh) -> dict:
    """Each group of layers of ``cfg``'s decode step → (its kind, its
    layout) under ``mesh`` (a placed mesh or a shape), by the caches' specs
    (``cache_blocks``) and the parameters' grouped by layer (``layers``,
    ``layer_specs`` of ``param_blocks``), as the step's ``_Rank`` lays each
    layer out."""
    out = {}
    for group, cuts in cache_cuts(cfg, cache_specs, mesh).items():
        kind, prefix = _GROUPS[group]
        out[group] = (kind, layout(kind, cuts, layers.get(prefix, {}), mesh))
    return out


class _Rank:
    """The step's layers on this rank's blocks under a placed mesh: the
    global ``batch``, every parameter's spec (``param_blocks``, grouped by
    layer in ``layers``, ``layer_specs``). A layout that no sharded body
    reads (``reads``) raises, naming the layer."""

    def __init__(self, mesh, batch: int, layers: dict):
        self.mesh, self.batch, self.layers = mesh, batch, layers
        self.bspec = _decode_bspec(mesh, batch)
        self.sharded = sharded_decode_on()

    def _check(self, prefix: str, kind: str, cuts) -> None:
        """Raises where the sharded bodies are on and none reads the layer's
        layout."""
        if self.sharded and not reads(kind, layout(kind, cuts, self.layers[prefix], self.mesh)):
            raise ValueError(f"decode under {dict(self.mesh)}: {prefix}'s blocks {self.layers[prefix]} and caches "
                             f"cut over 'model' along {tuple(cuts)}: no sharded body reads this layout")

    def _views(self, p, prefix: str, body: dict) -> dict:
        held = self.layers[prefix]
        return {n: _view(t, held[n], body.get(n, held[n]), self.mesh) for n, t in p.items() if t is not None}

    def _gathered(self, fn, p, prefix: str, caches=()):
        return gathered_layer(fn, dict(p.items()), self.layers[prefix], caches, self.mesh)

    def attention(self, p, prefix, h, kc, vc, pos, cfg, cut, *, is_global, ring):
        self._check(prefix, "self", (cut,))
        if not self.sharded:
            return self._gathered(lambda w, k, v: decode_attention(w, h, k, v, pos, cfg, is_global=is_global,
                                                                   ring=ring)[0], p, prefix, [(kc, cut), (vc, cut)])
        w = self._views(p, prefix, decode_attention_specs(cfg, self.mesh, self.batch))
        return decode_attention_sharded(w, h, kc, vc, pos, cfg, batch=self.batch, is_global=is_global, ring=ring,
                                        cut=cut)[0]

    def cross(self, p, prefix, h, ck, cv, cfg, cut):
        self._check(prefix, "cross", (cut,))
        if not self.sharded:
            return self._gathered(lambda w, k, v: cross_decode(w, h, k, v, cfg), p, prefix, [(ck, cut), (cv, cut)])
        w = self._views(p, prefix, decode_attention_specs(cfg, self.mesh, self.batch))
        return cross_decode_sharded(w, h, ck, cv, cfg, batch=self.batch, cut=cut)

    def mlp(self, p, prefix, h, cfg, *, kind: str | None = None, d_ff: int | None = None):
        if not self.sharded:
            return self._gathered(lambda w: mlp(w, h, kind or cfg.mlp), p, prefix)
        w = self._views(p, prefix, decode_mlp_specs(cfg, self.mesh, self.batch, d_ff=d_ff))
        return decode_mlp_sharded(w, h, cfg, batch=self.batch, kind=kind, d_ff=d_ff)

    def mla(self, p, prefix, h, c_kv, k_rope, pos, cfg, cuts):
        """On latent caches ``c_kv`` and ``k_rope`` each cut by its own spec
        (``mla.mla_decode_sharded``)."""
        self._check(prefix, "mla", cuts)
        if not self.sharded:
            return self._gathered(lambda w, c, r: mla_decode(w, h, c, r, pos, cfg)[0], p, prefix,
                                  [(c_kv, cuts[0]), (k_rope, cuts[1])])
        w = self._views(p, prefix, mla_decode_specs(cfg, self.mesh, self.batch))
        return mla_decode_sharded(w, h, c_kv, k_rope, pos, cfg, batch=self.batch, cuts=cuts)[0]

    def ffn(self, blk, prefix, h, cfg):
        """An MLA block's second half: its dense MLP, or the routed experts'
        gather dispatch on the held experts and the shared experts' MLP."""
        if blk.moe is None:
            return self.mlp(blk.mlp, f"{prefix}.mlp", h, cfg)
        p, mesh = blk.moe, self.mesh
        routed = {w: p[w] for w in ("router", "router_bias", "w_gate", "w_up", "w_down") if w in p}
        logits = None
        if p.router.shape[0] != cfg.d_model:        # the router's d cut over 'data': its logits weight-stationary
            logits, = col_proj(h.float(), [p.router], cfg.d_model, mesh, self.bspec)
        y, _ = moe_gather_sharded(routed, h, cfg, mesh, self.layers[f"{prefix}.moe"], self.bspec, logits=logits)
        if p.shared is None:
            return y
        return y + self.mlp(p.shared, f"{prefix}.moe.shared", h, cfg, kind="swiglu",
                            d_ff=cfg.moe_d_ff * cfg.num_shared_experts)

    def rglru(self, p, prefix, h, hc, conv, cfg, cuts):
        """Channel-parallel where the rules cut the width (the gates'
        columns, and h and conv along it or along their rows) or nothing
        over 'model'."""
        self._check(prefix, "rglru", cuts)
        if not self.sharded:
            return self._gathered(lambda w, s, c: rglru_decode(w, h, s, c, cfg)[0], p, prefix,
                                  [(hc, cuts[0]), (conv, cuts[1])])
        return rglru_decode_sharded(p, h, hc, conv, cfg, self.mesh, batch=self.batch, rows=cuts[0] == 0)

    def mamba(self, p, prefix, h, conv, state, cfg, cuts):
        """On the rank's blocks of conv (its channels or its rows) and state
        (its rows, heads or N-block)."""
        self._check(prefix, "mamba", cuts)
        conv_cut, state_cut = cuts
        if not self.sharded:
            return self._gathered(lambda w, c, s: mamba_decode(w, h, c, s, cfg)[0], p, prefix,
                                  [(conv, conv_cut), (state, state_cut)])
        return mamba_decode_sharded(p, h, conv, state, cfg, self.mesh, batch=self.batch, conv_cut=conv_cut,
                                    state_cut=state_cut)


# ---------------------------------------------------------------------------
# the blocks' specs
# ---------------------------------------------------------------------------

def _lead_axes(cfg: ModelConfig, name: str) -> int:
    """The stacked layer axes before the batch dimension of cache ``name``."""
    two = {"dense": ("local_k", "local_v", "global_k", "global_v"), "vlm": ("k", "v"), "hybrid": ("h", "conv")}
    return 2 if name in two.get(cfg.family, ()) else 1


def cache_blocks(lm, batch: int, max_len: int, *, frames: int | None = None, mesh=None, abstract=None) -> dict:
    """The spec of a rank's block of every cache ``init_cache`` allocates
    under the current (placed) mesh, or under ``mesh`` (a shape will do),
    for the global batch ``batch`` (the cache tree's structure):
    ``runtime.sharding.cache_spec`` of each leaf of ``abstract``, by
    default ``runtime.serve.abstract_cache(lm, batch, max_len,
    frames=frames)`` (encdec's cross caches over ``frames`` audio frames,
    max_len by default), the reference's ``cache_specs`` but for its batch dimension:
    the leaf's own, after its stacked layer axes, where the reference
    would take a stacked axis as long as the batch (ROADMAP C13; the same
    bytes, since the two are as long)."""
    from ..runtime.serve import abstract_cache          # runtime imports the models
    from ..runtime.sharding import cache_spec

    mesh = _placed_mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError("cache_blocks: no placed mesh is current (launch.mesh.make_mesh, pspec.logical_axis_rules)")
    cfg = lm.cfg

    def spec(name: str, t) -> tuple:
        return cache_spec(mesh, t.shape, batch, _lead_axes(cfg, name))

    return {k: ({n: spec(n, t) for n, t in v.items()} if isinstance(v, dict) else spec(k, v))
            for k, v in (abstract or abstract_cache(lm, batch, max_len, frames=frames)).items()}


def param_blocks(lm) -> dict:
    """The spec of a rank's block of every parameter of ``lm`` under the
    current (placed) mesh: the reference's serve step's,
    ``runtime.sharding.param_specs(mesh, lm, serve=True)`` (TP over 'model',
    and ZeRO over 'data' where ``needs_zero3(..., serve=True)`` finds the
    TP-only blocks too large)."""
    from ..runtime.sharding import param_specs          # runtime imports the models

    mesh = _placed_mesh()
    if mesh is None:
        raise ValueError("param_blocks: no placed mesh is current (launch.mesh.make_mesh, pspec.logical_axis_rules)")
    return param_specs(mesh, lm, serve=True)


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------

def _cross_kv_block(params, src: torch.Tensor, cut, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """A cross layer's keys and values (B, N, KV, D) over its source src
    (B, N, d), or where a mesh cuts them over 'model' along dimension
    ``cut``, only this rank's block of them: the source's rows or
    positions, or the whole weights' kv heads or columns."""
    wk, wv = params["wk"], params["wv"]
    if cut is not None:
        r, m = mesh.coords["model"], mesh["model"]
        if cut < 2:
            n = src.shape[cut] // m
            src = src.narrow(cut, r * n, n)
        else:
            n = wk.shape[cut - 1] // m
            wk, wv = wk.narrow(cut - 1, r * n, n), wv.narrow(cut - 1, r * n, n)
    return _heads(src, wk, *wk.shape[1:]), _heads(src, wv, *wv.shape[1:])


def _cross_cache(blocks, src: torch.Tensor, cfg: ModelConfig, z, batch: int, mesh=None, cut=None) -> dict:
    """Each cross layer's keys and values over ``src`` (B, N, d), stacked:
    (n, B, N, KV, D), allocated by ``init_cache``'s ``z`` for the global
    ``batch`` (under a mesh, ``src`` holds this rank's rows of it and each
    layer's block is cut over 'model' along ``cut``)."""
    N = src.shape[1]
    cache = {name: z(name, len(blocks), batch, N, cfg.num_kv_heads, cfg.head_dim_, dtype=src.dtype)
             for name in ("cross_k", "cross_v")}
    rows = src.shape[0] // (mesh["model"] if cut == 0 else 1)
    if cache["cross_k"].shape[1] != rows:
        raise ValueError(f"{cfg.name}: {src.shape[0]} rows of cross-attention input for a cache of "
                         f"{cache['cross_k'].shape[1]} rows")
    for i, b in enumerate(blocks):
        cache["cross_k"][i], cache["cross_v"][i] = _cross_kv_block(b.attn, src, cut, mesh)
    return cache


def _encode_sharded(lm, audio_embeds: torch.Tensor, mesh) -> torch.Tensor:
    """Whisper's encoder over this rank's rows of the frames as the sharded
    prefill runs it, on views of the rank's blocks of ``lm``'s parameters
    (``param_blocks``): the same (B_loc, frames, d) on every rank of 'model'."""
    from ..runtime.serve import local_lm                # runtime imports the models
    from ..runtime.sharding import batch_axes

    specs = param_blocks(lm)
    view = local_lm(lm, specs, mesh, copy=False)
    view.placement = Placement(mesh, specs, math.prod(mesh[a] for a in batch_axes(mesh)))
    return view.encode(audio_embeds)


@torch.no_grad()
def init_cache(lm, batch: int, max_len: int, *, image_embeds: torch.Tensor | None = None,
               audio_embeds: torch.Tensor | None = None) -> dict[str, Any]:
    """Caches on ``lm``'s device (zeros, but for the cross K/V that vlm
    computes from ``image_embeds`` (B, N, d) and encdec from the encoder's
    pass over ``audio_embeds``), in the reference's shapes and types.

    Under a placed mesh, for the global batch ``batch`` (``lm`` the whole
    model): each cache is this rank's block of its unsharded shape, cut by
    its spec in ``cache_blocks``; ``image_embeds`` / ``audio_embeds`` are
    then this rank's rows, whisper's encoder runs on the rank's blocks and
    each cross layer projects only the rank's block of its keys and
    values."""
    from ..runtime.sharding import local_block        # runtime imports the models

    cfg: ModelConfig = lm.cfg
    fam = cfg.family
    KV, D = cfg.num_kv_heads, cfg.head_dim_
    dev = lm.device
    mesh = _placed_mesh()
    frames = None if audio_embeds is None else audio_embeds.shape[1]
    specs = None if mesh is None else cache_blocks(lm, batch, max_len, frames=frames)

    def z(name: str, *shape: int, dtype=cfg.cdtype) -> torch.Tensor:
        """Zeros for the cache ``name`` of the unsharded ``shape`` (under a
        mesh, of this rank's block of it)."""
        if specs is not None:
            spec = specs
            for key in name.split("/"):
                spec = spec[key]
            shape = local_block(torch.empty(shape, device="meta"), spec, mesh).shape
        return torch.zeros(shape, dtype=dtype, device=dev)

    def cross_cut():
        return None if specs is None else _model_dim(specs["cross_k"][1:], mesh)

    W = min(cfg.local_window, max_len)
    if fam == "dense":
        if _uses_rings(cfg):
            n_p, pat = _pattern_period(cfg)
            return {f"{kind}_{kv}": z(f"{kind}_{kv}", n_p, pat.count(c), batch, S, KV, D)
                    for kind, c, S in (("local", "L", W), ("global", "G", max_len)) for kv in "kv"}
        return {kv: z(kv, cfg.num_layers, batch, max_len, KV, D) for kv in "kv"}
    if fam == "vlm":
        if image_embeds is None:
            raise ValueError(f"{cfg.name}: vlm caches need image_embeds (the cross K/V)")
        k_every = cfg.cross_attn_every
        cache = {kv: z(kv, cfg.num_layers // k_every, k_every - 1, batch, max_len, KV, D) for kv in "kv"}
        return cache | _cross_cache(lm.cross_blocks, image_embeds.to(cfg.cdtype), cfg, z, batch, mesh, cross_cut())
    if fam == "moe":
        k = cfg.first_k_dense
        parts = {"moe": cfg.num_layers - k} | ({"dense": k} if k else {})
        cache = {part: init_mla_cache(cfg, batch, max_len, n, device="meta") for part, n in parts.items()}
        return {part: {name: z(f"{part}/{name}", *t.shape, dtype=t.dtype) for name, t in leaves.items()}
                for part, leaves in cache.items()}
    if fam == "ssm":
        return {name: z(name, *t.shape, dtype=t.dtype)
                for name, t in init_mamba_cache(cfg, batch, cfg.num_layers, device="meta").items()}
    if fam == "hybrid":
        n_p, rem = hybrid_periods(cfg)
        st = {k: t[0] for k, t in init_rglru_state(cfg, batch, 1, device="meta").items()}   # one layer's state
        cache = {k: z(k, n_p, 2, *t.shape, dtype=t.dtype) for k, t in st.items()}           # two a period
        cache |= {"ring_k": z("ring_k", n_p, batch, W, KV, D), "ring_v": z("ring_v", n_p, batch, W, KV, D)}
        if rem:
            cache |= {f"extra_{k}": z(f"extra_{k}", rem, *t.shape, dtype=t.dtype) for k, t in st.items()}
        return cache
    if fam == "encdec":
        if audio_embeds is None:
            raise ValueError(f"{cfg.name}: encdec caches need audio_embeds (the encoder's input)")
        cache = {kv: z(kv, cfg.num_layers, batch, max_len, KV, D) for kv in "kv"}
        enc = lm.encode(audio_embeds) if mesh is None else _encode_sharded(lm, audio_embeds, mesh)
        return cache | _cross_cache(lm.dec_cross, enc, cfg, z, batch, mesh, cross_cut())
    raise ValueError(fam)


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _table_rows(lm, name: str, mesh, specs: dict) -> tuple[TableRows, bool]:
    """(``name``'s ``TableRows`` on this rank, whether its width is cut over
    'data') under ``mesh``, by its spec in ``specs`` (none: the whole
    table)."""
    spec = specs.get(name, (None, None))
    return TableRows.of(getattr(lm, name), spec, mesh), spec[1] == "data"


def _rank_rows(x: torch.Tensor, mesh, bspec, rows: int) -> torch.Tensor:
    """This rank's ``rows`` of x, whose leading dimension holds every row of
    the batch axes ``bspec``."""
    r0 = _batch_row_start(mesh, bspec, rows)
    return x[r0:r0 + rows]


def _lookup(lm, tokens_t: torch.Tensor, mesh, batch: int, specs: dict) -> torch.Tensor:
    """The embedding of this rank's tokens under ``mesh``: vocab-parallel
    over 'model' on the rank's rows; where the width is cut over 'data' on
    every row of the batch axes, the (B, 1, d/n) blocks gathered along d
    over 'data', the rank's rows kept."""
    rows, wide = _table_rows(lm, "embed", mesh, specs)
    if not wide:
        return lm._embed(tokens_t, rows)
    bspec = _decode_bspec(mesh, batch)
    x = all_gather(lm._embed(_gather_batch(tokens_t, bspec, mesh), rows), "data", mesh, dim=-1)
    return _rank_rows(x, mesh, bspec, tokens_t.shape[0])


def _head_logits(lm, x: torch.Tensor, mesh, batch: int, specs: dict) -> torch.Tensor:
    """This rank's rows' logits under ``mesh``, whole along V: the rank's
    (…, V/m) block gathered over 'model'; where the width is cut over
    'data', weight-stationary: the normed rows of the batch axes gathered,
    the rank's (V/m, d/n) block contracted, the float32 partials summed
    over 'data' and rounded once (``attention._psum_proj``), the rank's
    rows kept."""
    name = "embed" if lm.cfg.tie_embeddings else "unembed"
    rows, wide = _table_rows(lm, name, mesh, specs)
    if not wide:
        return lm._logits(x, rows)
    bspec = _decode_bspec(mesh, batch)
    h = _gather_batch(rms_norm(x, lm.final_norm), bspec, mesh)
    logits = _psum_proj(h, rows.table.t(), lm.cfg.d_model, mesh).to(torch.float32)
    return lm._vocab_logits(_rank_rows(logits, mesh, bspec, x.shape[0]), rows.mesh)


@torch.no_grad()
def decode_step(lm, tokens_t: torch.Tensor, cache: dict, pos: int, *, batch: int | None = None,
                specs: dict | None = None, cache_specs: dict | None = None, layers: dict | None = None):
    """tokens_t (B, 1) integer; pos an int → (logits (B, 1, V) float32,
    cache), the cache updated in place. Layers run in the reference's
    order: with local dense layers period by period, locals before
    globals within a period (the natural order for the contiguous L…G
    patterns of the dense configs); the moe family's dense layers before
    its routed ones; the hybrid's two recurrent blocks before its
    attention block in each period, then the trailing ones.

    Under a placed mesh: ``lm`` holds this rank's parameter blocks, cut
    by ``specs`` (``param_blocks``), ``cache`` its cache blocks, cut by
    ``cache_specs`` (``cache_blocks``; ``init_cache`` allocates them),
    tokens_t its rows of the global batch ``batch``, and the logits are
    those rows', whole along V. ``layers`` is ``layer_specs(specs)``, which
    a caller that steps many times makes once (None: made here)."""
    cfg: ModelConfig = lm.cfg
    fam = cfg.family
    pos = int(pos)
    mesh = _placed_mesh()
    if mesh is None:
        ops = _OneDevice()
    else:
        if batch is None or specs is None or cache_specs is None:
            raise ValueError("decode_step under a placed mesh takes the global batch and the blocks' specs")
        if tokens_t.shape[0] != _rows(mesh, batch, _decode_bspec(mesh, batch)):
            raise ValueError(f"decode_step: {tokens_t.shape[0]} rows of tokens for a global batch {batch} over "
                             f"{_decode_bspec(mesh, batch)}")
        ops = _Rank(mesh, batch, layer_specs(specs) if layers is None else layers)
    cuts = collections.defaultdict(lambda: (None, None)) if mesh is None else cache_cuts(cfg, cache_specs, mesh)
    with tracing.span("decode.embed"):
        x = lm._embed(tokens_t) if mesh is None else _lookup(lm, tokens_t, mesh, batch, specs)
    if fam == "dense":
        blocks = lm.blocks
        if _uses_rings(cfg):
            n_p, pat = _pattern_period(cfg)
            period = len(pat)
            kinds = (("local", [i for i, c in enumerate(pat) if c == "L"], False),
                     ("global", [i for i, c in enumerate(pat) if c == "G"], True))
            for p in range(n_p):
                for kind, idx, is_global in kinds:
                    cut = cuts[kind][0]
                    for n, i in enumerate(idx):
                        j = p * period + i
                        x = _attn_block(ops, blocks[j], f"blocks.{j}", x, cache[f"{kind}_k"][p, n],
                                        cache[f"{kind}_v"][p, n], pos, cfg, cut, is_global=is_global,
                                        ring=not is_global)
        else:
            cut = cuts["self"][0]
            for i, blk in enumerate(blocks):
                x = _attn_block(ops, blk, f"blocks.{i}", x, cache["k"][i], cache["v"][i], pos, cfg, cut,
                                is_global=True, ring=False)
    elif fam == "vlm":
        cut, cross = cuts["self"][0], cuts["cross"][0]
        for p, (selfs, xblk) in enumerate(zip(lm.self_blocks, lm.cross_blocks)):
            for j, blk in enumerate(selfs):
                x = _attn_block(ops, blk, f"self_blocks.{p}.{j}", x, cache["k"][p, j], cache["v"][p, j], pos, cfg,
                                cut, is_global=True, ring=False)
            x = _cross_block(ops, xblk, f"cross_blocks.{p}", x, cache["cross_k"][p], cache["cross_v"][p], cfg, cross)
    elif fam == "moe":
        for part, name in (("dense", "dense_blocks"), ("moe", "moe_blocks")):
            if part not in cache:
                continue
            for i, blk in enumerate(getattr(lm, name)):
                x = _mla_block(ops, blk, f"{name}.{i}", x, cache[part]["c_kv"][i], cache[part]["k_rope"][i], pos,
                               cfg, cuts[part])
    elif fam == "ssm":
        for i, blk in enumerate(lm.blocks):
            x = x + ops.mamba(blk.mix, f"blocks.{i}.mix", rms_norm(x, blk.ln), cache["conv"][i], cache["state"][i],
                              cfg, cuts["mamba"])
    elif fam == "hybrid":
        ring = cuts["ring"][0]
        for p, (recs, attn) in enumerate(zip(lm.rec_blocks, lm.attn_blocks)):
            for j, blk in enumerate(recs):
                x = _rec_block(ops, blk, f"rec_blocks.{p}.{j}", x, cache["h"][p, j], cache["conv"][p, j], cfg,
                               cuts["rec"])
            x = _attn_block(ops, attn, f"attn_blocks.{p}", x, cache["ring_k"][p], cache["ring_v"][p], pos, cfg, ring,
                            is_global=False, ring=True)
        for i, blk in enumerate(getattr(lm, "extra_rec", ())):
            x = _rec_block(ops, blk, f"extra_rec.{i}", x, cache["extra_h"][i], cache["extra_conv"][i], cfg,
                           cuts["extra"])
    elif fam == "encdec":
        cut, cross = cuts["self"][0], cuts["cross"][0]
        for i, (self_blk, xblk) in enumerate(zip(lm.dec_self, lm.dec_cross)):
            x = _attn_block(ops, self_blk, f"dec_self.{i}", x, cache["k"][i], cache["v"][i], pos, cfg, cut,
                            is_global=True, ring=False)
            x = _cross_block(ops, xblk, f"dec_cross.{i}", x, cache["cross_k"][i], cache["cross_v"][i], cfg, cross)
    else:
        raise ValueError(fam)
    with tracing.span("decode.head"):
        logits = lm._logits(x) if mesh is None else _head_logits(lm, x, mesh, batch, specs)
    return logits, cache
