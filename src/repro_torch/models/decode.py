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
current mesh of ``runtime.pspec.logical_axis_rules``) each rank runs the
step on its rows of the global batch (``attention._decode_bspec``), as the
reference's sharded step does: every block that the reference runs
through ``_attn_decode_block`` takes the sharded attention
(``attention.decode_attention_sharded``, through the decode kernel's
key-range entry) where ``_sharded_decode_applicable`` holds for its cache's
global length, and the sharded MLP where ``_sharded_mlp_applicable`` holds;
the norms, cross layers and recurrent blocks, which the reference leaves
outside its ``shard_map`` bodies, run on the rank's rows with whole
weights. The embedding and the unembedding stay cut as the reference's
serve step holds them (``runtime.sharding.param_specs(..., serve=True)``:
vocab over 'model', and width over 'data' where serving's ZeRO applies):
the lookup is vocab-parallel (``layers.vocab_embed``), the logits each
rank's (…, V/m) block gathered along V over 'model', and where the width
is cut too both run weight-stationary, as ``attention._psum_proj`` does:
the one-token rows gathered over the batch axes, the rank's (V/m, d/n)
block contracted, the float32 partials summed over 'data' with one
rounding, the rank's rows kept. No table moves in a decode step.
``init_cache`` then allocates only the rank's block of each cache
(``cache_blocks``), and ``param_blocks`` gives the specs by which a
rank's parameters are cut (``runtime.serve`` cuts them).

The moe and ssm families, whose decode the reference leaves to XLA's
SPMD partitioner under a mesh, run so too. An MLA block takes
``mla.mla_decode_sharded`` where the cache's global length allows the
sharded decode (its latent caches cut as ``mla_decode_specs`` reads them,
rows over the batch axes and S over 'model'), its dense MLP the sharded
MLP, and its routed experts the gather dispatch of the sharded batch
(``moe.moe_gather_sharded``: the one-token step's global capacity and
slots; the a2a never applies to one token), the experts cut as
``runtime.sharding.param_specs`` cuts them for training, the shared
experts whole on the rank's rows. The Mamba-2 blocks run on the rank's
rows with whole weights, as the hybrid's RG-LRU blocks do: their ``conv``
and ``state`` caches (like the hybrid's ``conv`` and ``h``) are cut by
rows only, where the reference's ``cache_specs`` would also cut ``state``
along N and ``conv`` along its channels over 'model'.
"""
from __future__ import annotations

from typing import Any

import torch

from ..launch.mesh import all_gather, placed, spec_axes
from .attention import (_batch_row_start, _decode_bspec, _gather_batch, _psum_proj, _rows, _sharded_decode_applicable,
                        _sharded_mlp_applicable, cross_decode, cross_kv, current_mesh, decode_attention,
                        decode_attention_sharded, decode_attention_specs, decode_mlp_sharded, decode_mlp_specs)
from .common import ModelConfig
from .layers import mlp, rms_norm
from .lm import MLABlock, TableRows, hybrid_periods
from .mla import init_mla_cache, mla_decode, mla_decode_sharded, mla_decode_specs
from .moe import _shared, moe_gather_sharded
from .rglru import init_rglru_state, rglru_decode
from .ssm import init_mamba_cache, mamba_decode

__all__ = ["init_cache", "decode_step", "cache_blocks", "param_blocks"]


def _attn_decode_block(p, x_t, kc, vc, pos: int, cfg: ModelConfig, *, is_global: bool, ring: bool,
                       batch: int | None = None, S: int | None = None):
    """One attention block; under a placed mesh (``batch``, the global
    batch, given) the sharded attention where the cache's global length
    ``S`` allows it and the sharded MLP, as the reference's block does."""
    h = rms_norm(x_t, p.ln1)
    if batch is not None and _sharded_decode_applicable(S):
        a, kc, vc = decode_attention_sharded(p.attn, h, kc, vc, pos, cfg, batch=batch, is_global=is_global,
                                             ring=ring)
    else:
        a, kc, vc = decode_attention(p.attn, h, kc, vc, pos, cfg, is_global=is_global, ring=ring)
    x = x_t + a
    h2 = rms_norm(x, p.ln2)
    if batch is not None and _sharded_mlp_applicable():
        return x + decode_mlp_sharded(p.mlp, h2, cfg, batch=batch), kc, vc
    return x + mlp(p.mlp, h2, cfg.mlp), kc, vc


def _cross_block(p, x_t, ck, cv, cfg: ModelConfig):
    h = cross_decode(p.attn, rms_norm(x_t, p.ln1), ck, cv, cfg)
    if p.xgate is not None:
        h = h * torch.tanh(p.xgate).to(h.dtype)
    x = x_t + h
    return x + mlp(p.mlp, rms_norm(x, p.ln2), cfg.mlp)


def _mla_block(p, x_t, c_kv, k_rope, pos: int, cfg: ModelConfig, *, batch: int | None = None,
               S: int | None = None, experts: dict | None = None):
    """One MLA block; under a placed mesh (``batch``, the global batch,
    given) the sharded MLA decode where the caches' global length ``S``
    allows it, the sharded MLP, and the routed experts' gather dispatch
    of the sharded batch on the blocks ``experts`` specifies."""
    h = rms_norm(x_t, p.ln1)
    if batch is not None and _sharded_decode_applicable(S):
        a, _, _ = mla_decode_sharded(p.attn, h, c_kv, k_rope, pos, cfg, batch=batch)
    else:
        a, _, _ = mla_decode(p.attn, h, c_kv, k_rope, pos, cfg)
    x = x_t + a
    h2 = rms_norm(x, p.ln2)
    if batch is None:
        return x + p.ffn(h2, cfg)[0]
    if p.moe is not None:
        routed = {w: p.moe[w] for w in ("router", "router_bias", "w_gate", "w_up", "w_down") if w in p.moe}
        y, _ = moe_gather_sharded(routed, h2, cfg, current_mesh(), experts, _decode_bspec(current_mesh(), batch))
        B, _, d = h2.shape
        return x + _shared(p.moe, h2.reshape(B, d), y.reshape(B, d)).view(B, 1, d)
    if _sharded_mlp_applicable():
        return x + decode_mlp_sharded(p.mlp, h2, cfg, batch=batch)
    return x + mlp(p.mlp, h2, cfg.mlp)


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


def _cross_cache(blocks, src: torch.Tensor, cfg: ModelConfig, z, batch: int) -> dict:
    """Each cross layer's keys and values over ``src`` (B, N, d), stacked:
    (n, B, N, KV, D), allocated by ``init_cache``'s ``z`` for the global
    ``batch`` (under a mesh, ``src`` holds this rank's rows of it)."""
    N = src.shape[1]
    cache = {name: z(name, len(blocks), batch, N, cfg.num_kv_heads, cfg.head_dim_, dtype=src.dtype)
             for name in ("cross_k", "cross_v")}
    if cache["cross_k"].shape[1] != src.shape[0]:
        raise ValueError(f"{cfg.name}: {src.shape[0]} rows of cross-attention input for a cache of "
                         f"{cache['cross_k'].shape[1]} rows")
    for i, b in enumerate(blocks):
        cache["cross_k"][i], cache["cross_v"][i] = cross_kv(b.attn, src, cfg)
    return cache


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------

def _placed_mesh():
    """The current mesh if it is placed over a process group, else None."""
    mesh = current_mesh()
    return mesh if placed(mesh) else None


def _self_attention_blocks(lm, max_len: int):
    """(parameter prefix, global cache length) of every block the decode
    step runs through ``_attn_decode_block``."""
    cfg = lm.cfg
    fam = cfg.family
    W = min(cfg.local_window, max_len)
    if fam == "dense":
        if _uses_rings(cfg):
            n_p, pat = _pattern_period(cfg)
            return [(f"blocks.{i}", W if c == "L" else max_len) for i, c in enumerate(pat * n_p)]
        return [(f"blocks.{i}", max_len) for i in range(cfg.num_layers)]
    if fam == "vlm":
        return [(f"self_blocks.{p}.{j}", max_len) for p, selfs in enumerate(lm.self_blocks) for j in range(len(selfs))]
    if fam == "hybrid":
        return [(f"attn_blocks.{p}", W) for p in range(len(lm.attn_blocks))]
    if fam == "encdec":
        return [(f"dec_self.{i}", max_len) for i in range(cfg.num_layers)]
    return []


def _expert_specs(lm, mesh) -> dict:
    """The specs of a moe layer's routed experts under ``mesh``, as
    ``runtime.sharding.param_specs`` cuts them for training: over 'model'
    × 'data' where E divides it, else E over 'model' and d over 'data'."""
    from ..runtime.sharding import param_specs       # runtime imports the models

    E, d, f = lm.cfg.num_experts, lm.cfg.d_model, lm.cfg.moe_d_ff
    shapes = {"w_gate": (E, d, f), "w_up": (E, d, f), "w_down": (E, f, d)}
    specs = param_specs(mesh, {f"moe_blocks.0.moe.{w}": s for w, s in shapes.items()}, zero3=True)
    return {name.rpartition(".")[2]: spec for name, spec in specs.items()}


def _same_spec(mesh, a: tuple, b: tuple) -> bool:
    """Two specs shard alike: the same axes of size > 1 on every dimension."""
    norm = lambda e: tuple(x for x in spec_axes(e) if mesh.get(x, 1) > 1)  # noqa: E731
    return len(a) == len(b) and all(norm(x) == norm(y) for x, y in zip(a, b))


def cache_blocks(lm, batch: int, max_len: int) -> dict:
    """The spec of a rank's block of every cache ``init_cache`` allocates
    under the current (placed) mesh for the global batch ``batch``: a
    self-attention cache whose global length S takes the sharded attention
    is cut as ``decode_attention_specs``' cache, rows over the batch axes and
    S over 'model' (checked against ``runtime.sharding.cache_specs``: raises
    where they differ); every other cache by rows only. The stacked layer
    axes lead, unsharded."""
    from ..runtime.sharding import cache_specs        # runtime imports the models

    cfg = lm.cfg
    fam = cfg.family
    mesh = _placed_mesh()
    if mesh is None:
        raise ValueError("cache_blocks: no placed mesh is current (launch.mesh.make_mesh, pspec.logical_axis_rules)")
    bspec = _decode_bspec(mesh, batch)
    W = min(cfg.local_window, max_len)

    def attn(lead: tuple, S: int, name: str, tail: tuple | None = None) -> tuple:
        """A self-attention cache (*lead, B, S, KV, D), lead its stacked layer
        axes (with ``tail``, an MLA latent cache (*lead, B, S, *tail))."""
        if tail is None:
            tail, read = (cfg.num_kv_heads, cfg.head_dim_), decode_attention_specs(cfg, mesh, batch)["cache"]
        else:
            read = mla_decode_specs(cfg, mesh, batch)["cache"]
        spec = (None,) * len(lead) + read
        if not _sharded_decode_applicable(S):
            return (None,) * len(lead) + (bspec, None) + (None,) * len(tail)
        shape = lead + (batch, S) + tail
        want = cache_specs(mesh, torch.empty(shape, device="meta"), batch)
        if not _same_spec(mesh, want, spec):
            raise ValueError(f"{cfg.name}: cache {name} {shape} would be cut as {want} by "
                             f"runtime.sharding.cache_specs, and the sharded attention reads it as {spec}")
        return spec

    def rows(bdim: int, n: int) -> tuple:
        return (None,) * bdim + (bspec,) + (None,) * (n - bdim - 1)

    if fam == "dense":
        if _uses_rings(cfg):
            n_p, pat = _pattern_period(cfg)
            sp = {"local": attn((n_p, pat.count("L")), W, "local_k"),
                  "global": attn((n_p, pat.count("G")), max_len, "global_k")}
            return {f"{kind}_{kv}": sp[kind] for kind in ("local", "global") for kv in ("k", "v")}
        sp = attn((cfg.num_layers,), max_len, "k")
        return {"k": sp, "v": sp}
    if fam == "vlm":
        k_every = cfg.cross_attn_every
        sp = attn((cfg.num_layers // k_every, k_every - 1), max_len, "k")
        return {"k": sp, "v": sp, "cross_k": rows(1, 5), "cross_v": rows(1, 5)}
    if fam == "hybrid":
        n_p, rem = hybrid_periods(cfg)
        sp = attn((n_p,), W, "ring_k")
        out = {"h": rows(2, 4), "conv": rows(2, 5), "ring_k": sp, "ring_v": sp}
        if rem:
            out |= {"extra_h": rows(1, 3), "extra_conv": rows(1, 4)}
        return out
    if fam == "encdec":
        sp = attn((cfg.num_layers,), max_len, "k")
        return {"k": sp, "v": sp, "cross_k": rows(1, 5), "cross_v": rows(1, 5)}
    if fam == "moe":
        parts = {"moe": cfg.num_layers - cfg.first_k_dense} | ({"dense": cfg.first_k_dense} if cfg.first_k_dense
                                                              else {})
        return {part: {"c_kv": attn((n,), max_len, f"{part}/c_kv", (cfg.kv_lora_rank,)),
                       "k_rope": attn((n,), max_len, f"{part}/k_rope", (cfg.qk_rope_head_dim,))}
                for part, n in parts.items()}
    if fam == "ssm":
        return {"conv": rows(1, 4), "state": rows(1, 5)}
    raise ValueError(fam)


def table_specs(lm, mesh) -> dict:
    """The specs of the embedding (and the unembedding) of the whole model
    ``lm`` under ``mesh`` as the reference's serve step cuts them:
    ``runtime.sharding.param_specs`` with serving's ZeRO where
    ``needs_zero3(..., serve=True)`` finds the TP-only blocks too large
    (vocab over 'model', and width over 'data' then)."""
    from ..runtime.sharding import needs_zero3, param_specs       # runtime imports the models

    specs = param_specs(mesh, lm, needs_zero3(mesh, lm, serve=True))
    return {n: specs[n] for n in ("embed", "unembed") if n in specs}


def param_blocks(lm, batch: int, max_len: int) -> dict:
    """The spec of a rank's block of every parameter of ``lm`` under the
    current (placed) mesh for the global batch ``batch`` and caches of
    ``max_len``: the attention projections of a block that takes the
    sharded attention by ``decode_attention_specs``, every attention
    block's MLP by ``decode_mlp_specs`` where the sharded MLP applies, the
    embedding and the unembedding cut as the reference's serve step holds
    them (``table_specs``), and every other parameter whole (the
    reference's shard_map in_specs, which its decode step reshards to). An
    MLA block's projections by ``mla_decode_specs`` where the sharded MLA
    decode applies, its dense MLP by ``decode_mlp_specs``, its routed
    experts as training cuts them (``_expert_specs``): no rank holds every
    expert."""
    cfg = lm.cfg
    mesh = _placed_mesh()
    if mesh is None:
        raise ValueError("param_blocks: no placed mesh is current (launch.mesh.make_mesh, pspec.logical_axis_rules)")
    specs = {name: (None,) * p.dim() for name, p in lm.named_parameters()}
    specs |= table_specs(lm, mesh)
    attn, mlp_specs = decode_attention_specs(cfg, mesh, batch), decode_mlp_specs(cfg, mesh, batch)
    if cfg.family == "moe":
        mla, experts = mla_decode_specs(cfg, mesh, batch), _expert_specs(lm, mesh)
        for prefix, blk in ((n, b) for n, b in lm.named_modules() if isinstance(b, MLABlock)):
            if _sharded_decode_applicable(max_len):
                specs |= {f"{prefix}.attn.{w}": mla[w] for w in blk.attn}
            if blk.moe is not None:
                specs |= {f"{prefix}.moe.{w}": experts[w] for w in experts}
            elif _sharded_mlp_applicable():
                specs |= {f"{prefix}.mlp.{w}": mlp_specs[w] for w in blk.mlp}
    for prefix, S in _self_attention_blocks(lm, max_len):
        if _sharded_decode_applicable(S):
            for w in ("wq", "wk", "wv", "wo"):
                specs[f"{prefix}.attn.{w}"] = attn[w]
        if _sharded_mlp_applicable():
            for w in ("w_gate", "w_up", "w_down"):
                if f"{prefix}.mlp.{w}" in specs:
                    specs[f"{prefix}.mlp.{w}"] = mlp_specs[w]
    return specs


@torch.no_grad()
def init_cache(lm, batch: int, max_len: int, *, image_embeds: torch.Tensor | None = None,
               audio_embeds: torch.Tensor | None = None) -> dict[str, Any]:
    """Caches on ``lm``'s device (zeros, but for the cross K/V that vlm
    computes from ``image_embeds`` (B, N, d) and encdec from the encoder's
    pass over ``audio_embeds``), in the reference's shapes and types.

    Under a placed mesh, for the global batch ``batch``: each cache is this
    rank's block of its unsharded shape, cut by its spec in
    ``cache_blocks``; ``image_embeds`` / ``audio_embeds`` are then this
    rank's rows."""
    from ..runtime.sharding import local_block        # runtime imports the models

    cfg: ModelConfig = lm.cfg
    fam = cfg.family
    KV, D = cfg.num_kv_heads, cfg.head_dim_
    dev = lm.device
    mesh = _placed_mesh()
    specs = None if mesh is None else cache_blocks(lm, batch, max_len)

    def z(name: str, *shape: int, dtype=cfg.cdtype) -> torch.Tensor:
        """Zeros for the cache ``name`` of the unsharded ``shape`` (under a
        mesh, of this rank's block of it)."""
        if specs is not None:
            spec = specs
            for key in name.split("/"):
                spec = spec[key]
            shape = local_block(torch.empty(shape, device="meta"), spec, mesh).shape
        return torch.zeros(shape, dtype=dtype, device=dev)

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
        return cache | _cross_cache(lm.cross_blocks, image_embeds.to(cfg.cdtype), cfg, z, batch)
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
        return cache | _cross_cache(lm.dec_cross, lm.encode(audio_embeds), cfg, z, batch)
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
                max_len: int | None = None, specs: dict | None = None):
    """tokens_t (B, 1) integer; pos an int → (logits (B, 1, V) float32,
    cache), the cache updated in place. Layers run in the reference's
    order: with local dense layers period by period, locals before
    globals within a period (the natural order for the contiguous L…G
    patterns of the dense configs); the moe family's dense layers before
    its routed ones; the hybrid's two recurrent blocks before its
    attention block in each period, then the trailing ones.

    Under a placed mesh: ``lm`` holds this rank's parameter blocks, cut
    by ``specs`` (``param_blocks``, the tables cut too; a table without a
    spec there is whole), ``cache`` its cache blocks
    (``init_cache``), tokens_t its rows of the global batch ``batch``, and
    the logits are those rows', whole along V; ``max_len`` is the caches'
    global length."""
    cfg: ModelConfig = lm.cfg
    fam = cfg.family
    pos = int(pos)
    geo = lambda ring: {}  # noqa: E731
    mesh = _placed_mesh()
    if mesh is not None:
        if batch is None or max_len is None:
            raise ValueError("decode_step under a placed mesh takes the global batch and max_len")
        if tokens_t.shape[0] != _rows(mesh, batch, _decode_bspec(mesh, batch)):
            raise ValueError(f"decode_step: {tokens_t.shape[0]} rows of tokens for a global batch {batch} over "
                             f"{_decode_bspec(mesh, batch)}")
        W = min(cfg.local_window, max_len)
        geo = lambda ring: {"batch": batch, "S": W if ring else max_len}  # noqa: E731
    x = lm._embed(tokens_t) if mesh is None else _lookup(lm, tokens_t, mesh, batch, specs or {})
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
                        pos, cfg, is_global=False, ring=True, **geo(True))
                for n, i in enumerate(gi):
                    x, _, _ = _attn_decode_block(
                        blocks[p * period + i], x, cache["global_k"][p, n], cache["global_v"][p, n],
                        pos, cfg, is_global=True, ring=False, **geo(False))
        else:
            for i, blk in enumerate(blocks):
                x, _, _ = _attn_decode_block(blk, x, cache["k"][i], cache["v"][i], pos, cfg,
                                             is_global=True, ring=False, **geo(False))
    elif fam == "vlm":
        for p, (selfs, cross) in enumerate(zip(lm.self_blocks, lm.cross_blocks)):
            for j, blk in enumerate(selfs):
                x, _, _ = _attn_decode_block(blk, x, cache["k"][p, j], cache["v"][p, j], pos, cfg,
                                             is_global=True, ring=False, **geo(False))
            x = _cross_block(cross, x, cache["cross_k"][p], cache["cross_v"][p], cfg)
    elif fam == "moe":
        kw = {} if mesh is None else dict(geo(False), experts=_expert_specs(lm, mesh))
        for part, blocks in (("dense", getattr(lm, "dense_blocks", ())), ("moe", lm.moe_blocks)):
            for i, blk in enumerate(blocks):
                x = _mla_block(blk, x, cache[part]["c_kv"][i], cache[part]["k_rope"][i], pos, cfg, **kw)
    elif fam == "ssm":
        for i, blk in enumerate(lm.blocks):
            y, _, _ = mamba_decode(blk.mix, rms_norm(x, blk.ln), cache["conv"][i], cache["state"][i], cfg)
            x = x + y
    elif fam == "hybrid":
        for p, (recs, attn) in enumerate(zip(lm.rec_blocks, lm.attn_blocks)):
            for j, blk in enumerate(recs):
                x = _rec_block(blk, x, cache["h"][p, j], cache["conv"][p, j], cfg)
            x, _, _ = _attn_decode_block(attn, x, cache["ring_k"][p], cache["ring_v"][p], pos, cfg,
                                         is_global=False, ring=True, **geo(True))
        for i, blk in enumerate(getattr(lm, "extra_rec", ())):
            x = _rec_block(blk, x, cache["extra_h"][i], cache["extra_conv"][i], cfg)
    elif fam == "encdec":
        for i, (self_blk, cross) in enumerate(zip(lm.dec_self, lm.dec_cross)):
            x, _, _ = _attn_decode_block(self_blk, x, cache["k"][i], cache["v"][i], pos, cfg,
                                         is_global=True, ring=False, **geo(False))
            x = _cross_block(cross, x, cache["cross_k"][i], cache["cross_v"][i], cfg)
    else:
        raise ValueError(fam)
    return (lm._logits(x) if mesh is None else _head_logits(lm, x, mesh, batch, specs or {})), cache
