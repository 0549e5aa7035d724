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

``mla_decode_sharded`` is the reference's weight-stationary,
sequence-parallel form of that decode on a rank's blocks under a placed
mesh (``mla_decode_specs``): projections summed over 'data', W^UK and
W^UV applied on the rank's heads of wkv_b where they stay (the absorbed
queries gathered over 'model', one token a row), and the latent caches
read where the rules cut them over 'model': both along S, the shards'
softmax states combined by a max and two sums; both along the rows, the
rank's rows whole; c_kv along its latent dimension (max_len under 512 at
the published rank) with k_rope along S, its rows or its rope dimension,
each cache's share of the float32 scores summed over 'model'.
Its products are the reference's stock ones (the 576-wide latent key is no
instance of the decode kernel). The reference's moe decode does not call
it (its decode.py keeps the absorbed single-device form under XLA's
partitioner: "refuted"); the port's decode step under a placed mesh does
(``models.decode``) wherever the rules cut its caches.

``mla_sharded`` is the full-sequence MLA of training and prefill on a
rank's rows and its blocks under a mesh (``runtime.sharding.param_specs``'
cut): the latents whole on every rank of 'model' (wq_a and wkv_a gathered
whole along d), the rank's H/m heads of wq_b and wkv_b through the flash
kernel's (192, 128) instance forward and backward, wo's row-parallel
output summed over 'model' in float32. A head count that does not divide
'model' runs whole.
"""
from __future__ import annotations

import torch
from torch import nn

from .._device import warm_host_math
from ..launch.mesh import all_gather, all_reduce, gather_dims
from .attention import _attend, _decode_bspec, _rows, _write_block, col_proj, current_mesh, row_proj
from .common import ModelConfig
from .layers import init_linear_, linear, rms_norm, rope, row_parallel

__all__ = ["init_mla", "init_mla_", "mla_attention", "mla_decode", "init_mla_cache", "mla_decode_sharded",
           "mla_decode_specs", "mla_sharded"]

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
    """x (B, S, d) → qn (B, S, H, dn), rotated qr (B, S, H, dr), H the
    heads of wq_b (or wq): all of them, or a rank's."""
    B, S, _ = x.shape
    dn = cfg.qk_nope_head_dim
    dk = dn + cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        H = params["wq_b"].shape[1]
        cq = rms_norm(linear(x, params["wq_a"]), params["q_norm"])
        q = linear(cq, params["wq_b"].reshape(cfg.q_lora_rank, H * dk))
    else:
        H = params["wq"].shape[1]
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
    H, dv = cfg.num_heads, cfg.v_head_dim
    o = _prefill_heads(params, x, cfg)
    return linear(o.reshape(*x.shape[:2], H * dv), params["wo"].reshape(H * dv, cfg.d_model))


def _prefill_heads(params, x, cfg: ModelConfig) -> torch.Tensor:
    """The attention output (B, S, H, dv) of the heads of wq_b (or wq) and
    wkv_b, all of them or a rank's, over latents computed whole."""
    B, S, _ = x.shape
    rkv = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    H = params["wkv_b"].shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    qn, qr = _queries(params, x, cfg, positions)
    c_kv, k_rope = _latents(params, x, cfg, positions)
    kv = linear(c_kv, params["wkv_b"].reshape(rkv, H * (dn + dv))).view(B, S, H, dn + dv)
    kvb = kv.new_empty((B, S, H, dn + dr + dv))
    kvb[..., :dn] = kv[..., :dn]
    kvb[..., dn:dn + dr] = k_rope[:, :, None]
    kvb[..., dn + dr:] = kv[..., dn:]
    return _attend(torch.cat([qn, qr], dim=-1), kvb[..., :dn + dr], kvb[..., dn + dr:], cfg,
                   causal=True, window=0)


def mla_sharded(params, x: torch.Tensor, cfg: ModelConfig, mesh, specs: dict) -> torch.Tensor:
    """``mla_attention`` of a rank's rows x (B_loc, S, d) on its blocks, cut
    by ``specs`` (name → spec): every 'data' block gathered whole along d,
    the latents (c_kv, k_rope and the query's low-rank cq) computed whole,
    the rank's heads of wq_b (or wq) and wkv_b through the flash kernel
    (forward, and backward through ``FlashAttentionFn``), wo's row-parallel
    output summed over 'model' → (B_loc, S, d), the same on every rank of
    'model'. Heads the rules leave whole (they do not divide) run whole."""
    mla_sharded.calls += 1
    w = {n: gather_dims(t, specs[n], mesh, axes=("data",)) for n, t in params.items()}
    H_loc, dv = w["wkv_b"].shape[1], cfg.v_head_dim
    o = _prefill_heads(w, x, cfg).reshape(*x.shape[:2], H_loc * dv)
    wo = w["wo"].reshape(H_loc * dv, cfg.d_model)
    return linear(o, wo) if H_loc == cfg.num_heads else row_parallel(o, wo, mesh)


mla_sharded.calls = 0   # calls of the sharded full-sequence MLA (remat's recompute too), this process


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


def mla_decode_specs(cfg: ModelConfig, mesh, B: int) -> dict:
    """The reference's in_specs of ``mla_decode_sharded``'s body for the
    global batch B: x (B, 1, d) by rows; the input dimension of wq_a (or
    wq), wkv_a and wo's output over 'data' where it divides; the heads of
    wq_b (or wq), wkv_b and wo over 'model' where they divide; each cache
    (B, S, r) rows over the batch axes and S over 'model'."""
    bspec = _decode_bspec(mesh, B)
    m, dsz = mesh.get("model", 1), mesh.get("data", 1)
    d_ax = "data" if (dsz > 1 and cfg.d_model % dsz == 0) else None
    h_ax = "model" if cfg.num_heads % m == 0 else None
    specs = {"x": (bspec, None, None), "wkv_a": (d_ax, None), "kv_norm": (None,), "wkv_b": (None, h_ax, None),
             "wo": (h_ax, None, d_ax), "cache": (bspec, "model", None)}
    if cfg.q_lora_rank:
        specs |= {"wq_a": (d_ax, None), "q_norm": (None,), "wq_b": (None, h_ax, None)}
    else:
        specs["wq"] = (d_ax, h_ax, None)
    return specs


def _score_share(q: torch.Tensor, cache: torch.Tensor, cut, S: int, mesh) -> torch.Tensor:
    """This rank's share of the float32 scores (B_loc, H, 1, S) of the
    queries q (B_loc, 1, H, c) against a latent cache (B, S, c) held as
    the rank's block cut over 'model' along ``cut``: the sum of the shares
    over 'model' is the scores. Along c a partial product on the rank's
    slice; along S or the rows the rank's block of the scores in zeros
    elsewhere."""
    r = mesh.coords["model"]
    if cut == 2:
        c = cache.shape[2]
        return torch.einsum("bqhr,bkr->bhqk", q[..., r * c:(r + 1) * c].float(), cache.float())
    share = q.new_zeros((q.shape[0], q.shape[2], 1, S), dtype=torch.float32)
    if cut == 1:
        n = cache.shape[1]
        share[..., r * n:(r + 1) * n] = torch.einsum("bqhr,bkr->bhqk", q.float(), cache.float())
    else:
        n = cache.shape[0]
        share[r * n:(r + 1) * n] = torch.einsum("bqhr,bkr->bhqk", q[r * n:(r + 1) * n].float(), cache.float())
    return share


def mla_decode_sharded(params, x_t: torch.Tensor, c_kv_cache: torch.Tensor, k_rope_cache: torch.Tensor, pos: int,
                       cfg: ModelConfig, *, batch: int, cuts: tuple = (1, 1)):
    """One token in the absorbed form on this rank's blocks
    (``mla_decode_specs`` for the global batch ``batch``): x_t (B_loc, 1, d)
    and this layer's latent caches c_kv (B, S, rkv) and k_rope (B, S, dr),
    each held as the rank's block of its rows, cut over 'model' along the
    dimension ``cuts`` gives for it (c_kv's, k_rope's; None: whole, 0 the
    rows, 1 S, 2 the latent or rope dimension). Writes the token's latent
    and rotary key into the blocks that hold them (the shard that owns row
    ``pos``, the rank's rows, its slice) and returns (out (B_loc, 1, d),
    c_kv_cache, k_rope_cache).

    Both cut along S (the reference's layout): each shard's scores over
    its keys and the shards' softmax states combined by a max and two
    sums. Both along the rows: the rank's rows whole, their latents
    gathered. c_kv whole or along r: each cache's share of the float32
    scores (``_score_share``) summed over 'model', one softmax, and the
    latent of the rank's slice of r gathered. Any other pair raises. W^UV
    is applied on the rank's heads of wkv_b."""
    mesh = current_mesh()
    bspec = _decode_bspec(mesh, batch)
    Bl, m = _rows(mesh, batch, bspec), mesh.get("model", 1)
    c_cut, r_cut = cuts
    for cache, cut in ((c_kv_cache, c_cut), (k_rope_cache, r_cut)):
        if x_t.shape[0] != Bl or cache.shape[0] != (Bl // m if cut == 0 else Bl):
            raise ValueError(f"mla_decode_sharded: rows {x_t.shape[0]} and a cache of {cache.shape[0]} rows cut "
                             f"along {cut}, for a global batch {batch} over {bspec}")
    if cuts not in ((1, 1), (0, 0)) and c_cut not in (None, 2):
        raise ValueError(f"mla_decode_sharded: latent caches cut along {cuts} over 'model' (no body reads them)")
    S = c_kv_cache.shape[1] * (m if c_cut == 1 else 1)
    if not 0 <= pos < S:
        raise ValueError(f"mla_decode_sharded: pos {pos} outside a cache of {S}")
    d, H = cfg.d_model, cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    rkv, rq = cfg.kv_lora_rank, cfg.q_lora_rank
    # queries on the rank's heads, latents whole: weights stay, partial products sum over 'data'
    if rq:
        cq, kv_a = col_proj(x_t, [params["wq_a"], params["wkv_a"]], d, mesh, bspec)
        wq_b = params["wq_b"]                                     # (rq, H_loc, dn + dr)
        q = linear(rms_norm(cq, params["q_norm"]), wq_b.reshape(rq, -1)).reshape(Bl, 1, wq_b.shape[1], dn + dr)
    else:
        q, kv_a = col_proj(x_t, [params["wq"], params["wkv_a"]], d, mesh, bspec)
    H_loc = q.shape[2]
    h0 = mesh.coords["model"] * H_loc if H_loc != H else 0
    posb = torch.full((Bl, 1), pos, dtype=torch.int64, device=x_t.device)
    qn, qr = q[..., :dn], rope(q[..., dn:], posb, cfg.rope_theta)
    c_t = rms_norm(kv_a[..., :rkv], params["kv_norm"])
    kr_t = rope(kv_a[..., rkv:], posb, cfg.rope_theta)
    # the single-row write, into the blocks that hold row pos (along S only the shard that owns it)
    for cache, t, cut in ((c_kv_cache, c_t, c_cut), (k_rope_cache, kr_t, r_cut)):
        if cut != 1 or 0 <= pos - mesh.coords["model"] * cache.shape[1] < cache.shape[1]:
            _write_block(cache, t[:, 0], pos, cut, mesh)
    # W^UK absorbed on the rank's heads of wkv_b; the absorbed and rotary queries gathered over 'model'
    wkb = params["wkv_b"]                                         # (rkv, H_loc, dn + dv)
    qa = torch.cat([torch.einsum("bqhc,rhc->bqhr", qn, wkb[..., :dn]), qr], dim=-1)
    if H_loc != H:
        qa = all_gather(qa, "model", mesh, dim=2)
    q_abs, qr = qa[..., :rkv], qa[..., rkv:]
    scale = (dn + dr) ** -0.5
    if cuts == (1, 1):
        # absorbed attention over this shard's latents
        S_loc = c_kv_cache.shape[1]
        start = mesh.coords["model"] * S_loc
        s = (torch.einsum("bqhr,bkr->bhqk", q_abs, c_kv_cache)
             + torch.einsum("bqhc,bkc->bhqk", qr, k_rope_cache)).float() * scale
        valid = start + torch.arange(S_loc, device=x_t.device) <= pos
        s = torch.where(valid, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
        warm_host_math(s)
        M = all_reduce(s.amax(dim=-1), "model", mesh, op="max")       # (B_loc, H, 1)
        p = torch.exp(s - M[..., None])
        l = all_reduce(p.sum(dim=-1), "model", mesh)
        # the probabilities normalised by the global sum and rounded to the cache's type, as the one-device
        # decode's softmax is; each shard's latent sum kept in float32, rounded once after the sum over 'model'
        p = (p / torch.clamp(l, min=1e-30)[..., None]).to(c_kv_cache.dtype)
        lat = all_reduce(torch.einsum("bhqk,bkr->bqhr", p.float(), c_kv_cache.float()), "model", mesh).to(x_t.dtype)
    elif cuts == (0, 0):
        # the rank's rows whole, as the one-device decode reads them
        n = c_kv_cache.shape[0]
        rows = slice(mesh.coords["model"] * n, (mesh.coords["model"] + 1) * n)
        s = (torch.einsum("bqhr,bkr->bhqk", q_abs[rows], c_kv_cache)
             + torch.einsum("bqhc,bkc->bhqk", qr[rows], k_rope_cache)).float() * scale
        valid = torch.arange(S, device=x_t.device) <= pos
        warm_host_math(s)
        p = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1).to(x_t.dtype)
        lat = all_gather(torch.einsum("bhqk,bkr->bqhr", p, c_kv_cache), "model", mesh, dim=0)
    else:
        shares = [(q_abs, c_kv_cache, c_cut), (qr, k_rope_cache, r_cut)]
        parts = [_score_share(qp, c, cut, S, mesh) for qp, c, cut in shares if cut is not None]
        s = all_reduce(sum(parts), "model", mesh) if parts else 0
        s = (s + sum(torch.einsum("bqhr,bkr->bhqk", qp.float(), c.float()) for qp, c, cut in shares if cut is None)
             ) * scale
        valid = torch.arange(S, device=x_t.device) <= pos
        warm_host_math(s)
        p = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1).to(x_t.dtype)
        lat = torch.einsum("bhqk,bkr->bqhr", p, c_kv_cache)
        if c_cut == 2:                                            # the rank's slice of r, gathered
            lat = all_gather(lat, "model", mesh, dim=3)
    out = torch.einsum("bqhr,rhv->bqhv", lat[:, :, h0:h0 + H_loc], wkb[..., dn:])   # W^UV on the rank's heads
    # output projection: the rank's heads of wo row-parallel (weight-stationary)
    y = row_proj(out.reshape(Bl, 1, H_loc * dv), params["wo"].reshape(H_loc * dv, -1), d, mesh, bspec,
                 cut=H_loc != H)
    mla_decode_sharded.calls += 1
    return y, c_kv_cache, k_rope_cache


mla_decode_sharded.calls = 0   # layers run through the sharded MLA decode, this process
