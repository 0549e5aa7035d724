"""Attention: GQA with causal/local/global masks, soft-capping, cross
attention, the chunked online-softmax host path, and KV-cache decode
(the single-device half of ``repro.models.attention``).

On a CUDA tensor ``attention`` (prefill, self or cross, causal or not)
runs the flash-attention kernel and ``decode_attention``/``cross_decode``
the decode-attention kernel, for every layer and length (the reference's
own model path runs jnp attention and reaches its Pallas kernels only
from tests). On a host tensor they run the plain versions, and
``attention`` takes the reference's route between them: the
double-blocked ``_chunked`` path (banded for a local layer whose window
is at most an eighth of the keys, or whenever a side is longer than
``CHUNKED_THRESHOLD``), else the full-score plain version. Query and key
positions are 0…Sq−1 and 0…Sk−1 throughout, as every model path of the
reference passes them. The decode path writes the new token's key and
value into the cache in place and returns the cache.

The sharded decode (``decode_attention_sharded``, ``decode_mlp_sharded``)
runs under a mesh placed over a process group (``launch.mesh.make_mesh``,
made current by ``runtime.pspec.logical_axis_rules``): each rank runs the
body of the reference's ``shard_map`` on its own blocks, cut by the same
in_specs (``decode_attention_specs``, ``decode_mlp_specs``), and a
``jax.lax.psum``/``pmax``/``all_gather`` becomes the same collective over
the axis's process group (``launch.mesh``). Projections are partial
products over the weights' 'data' shard of the input dimension, summed
over 'data': weights never move, only the (B, 1, ·) decode activations,
the (B, H) and (B, H, D) softmax states cross ranks. A layer's cache
stays where the rules cut it (``decode_attention_block``): along S each
rank attends over its range through the decode kernel's key-range entry
(``key0``, ``lse``) and the ranks combine their (out, lse) pairs; along
its rows the kernel runs on the rank's rows and the one-token outputs
are gathered; along D the float32 partial scores are summed over
'model' and the rank's slice of the output gathered. A self-attention
cache (``decode_attention_sharded``, linear or a ring) and a cross cache
(``cross_decode_sharded``, every key visible, N in place of S) are read
so. A cut along the kv heads raises.

The sharded full-sequence attention and MLP (``attention_sharded``,
``mlp_sharded``; training and prefill) run on a rank's rows of the batch
and its blocks of the parameters, given the specs that
``runtime.sharding.param_specs`` cut them by (the model passes each layer
its own, from its ``placement``): Megatron over 'model' (wq,
wk, wv and w_gate, w_up column-parallel over the heads and the ff
dimension; wo and w_down row-parallel, their partial outputs summed over
'model' in float32 and rounded once, ``layers.row_parallel``), ZeRO-3
over 'data' (each block's input dimension gathered at
use, its gradient reduce-scattered back through the gather). The flash
kernel runs forward and backward on the rank's H/m query heads and the
kv heads they read, so GQA's rep stays the model's; self-attention causal
or not, and cross-attention over the rank's rows of the image embeddings
or of the encoder's output, under the reference's rules. A dimension the rules
leave whole (it does not divide) is computed whole on every rank. The
gradient convention is ``launch.mesh``'s: each rank's loss is its share,
1/m of its rows' along 'model'.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from .._device import warm_host_math
from ..kernels.decode_attention.ops import decode_attention as decode_attention_kernel
from ..kernels.flash_attention.ops import flash_attention
from ..launch.mesh import all_gather, all_reduce, gather_dims, spec_axes
from .common import ModelConfig
from .layers import init_linear_, linear, mlp_hidden, rope, row_parallel, softcap

__all__ = [
    "init_attention", "init_attention_", "attention", "decode_attention", "cross_decode",
    "cross_kv", "init_kv_cache", "rope_theta", "CHUNKED_THRESHOLD", "decode_attention_sharded",
    "decode_mlp_sharded", "decode_attention_specs", "decode_mlp_specs", "attention_sharded", "mlp_sharded",
    "cross_decode_sharded", "decode_attention_block", "col_proj", "row_proj", "sharded_decode_on",
]

NEG_INF = -2.0e38
# Above this length (of either side) the host path streams key blocks
# through the online softmax instead of materializing the scores
# (repro.models.attention.CHUNKED_THRESHOLD).
CHUNKED_THRESHOLD = 8192
Q_BLOCK = 512
KV_BLOCK = 1024


def init_attention(cfg: ModelConfig, device) -> nn.ParameterDict:
    """Uninitialised projections (``init_attention_`` fills them):
    wq (d, H, D), wk/wv (d, KV, D), wo (H, D, d); q_norm/k_norm (D,)
    float32 with QK-norm. Cross layers have the same parameters (their
    tanh gate belongs to the block)."""
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


def _heads(x, w, n: int, D: int):
    """x (B, S, d) · w (d, n, D) → (B, S, n, D)."""
    B, S, d = x.shape
    return linear(x, w.reshape(d, n * D)).view(B, S, n, D)


def _project(params, x, cfg: ModelConfig, src=None):
    """x (B, S, d), src (B, Sk, d) (x itself for self-attention) →
    q (B, S, H, D), k, v (B, Sk, KV, D)."""
    src = x if src is None else src
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = _heads(x, params["wq"], H, D)
    k = _heads(src, params["wk"], KV, D)
    v = _heads(src, params["wv"], KV, D)
    if cfg.qk_norm:
        q = _qk_norm(q, params["q_norm"])
        k = _qk_norm(k, params["k_norm"])
    return q, k, v


def _out(params, o, cfg: ModelConfig):
    """o (B, S, H, D) → (B, S, d)."""
    B, S, H, D = o.shape
    return linear(o.reshape(B, S, H * D), params["wo"].reshape(H * D, cfg.d_model))


# -- the chunked online-softmax host path ------------------------------------------

def _divisor_block(n: int, target: int) -> int:
    """Largest divisor of n that is ≤ target (a ragged length such as
    1601 image tokens falls back to its largest small factor)."""
    for b in range(min(target, n), 0, -1):
        if n % b == 0:
            return b
    return n


def _chunked(q, k, v, *, causal: bool, window: int, cap: float, scale: float,
             q_block: int = Q_BLOCK, kv_block: int = KV_BLOCK, banded: bool = False):
    """Double-blocked online-softmax attention, the reference's
    ``_chunked``: query blocks in turn, each streaming key blocks with a
    running max, sum and float32 accumulator; probabilities cast to the
    value type before their product. ``banded`` (a local layer) streams
    only the ≤ nw key blocks that can meet a query block's window.
    ``window`` > 0 masks keys at or past it (the caller passes 0 for a
    global layer). q (B, Sq, H, D); k (B, Sk, KV, D); v (B, Sk, KV, Dv)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    rep = H // KV
    q_block = _divisor_block(Sq, q_block)
    kv_block = _divisor_block(Sk, kv_block)
    nq, nk = Sq // q_block, Sk // kv_block
    nw = min(nk, (window + q_block - 1 + kv_block - 1) // kv_block + 1) \
        if banded and window > 0 else nk
    warm_host_math(q)
    dev = q.device
    outs = []
    for i in range(nq):
        q_i = q[:, i * q_block:(i + 1) * q_block].reshape(B, q_block, KV, rep, D).float()
        qp = torch.arange(i * q_block, (i + 1) * q_block, device=dev)[:, None]
        s0 = 0
        if nw < nk:
            end_b = ((i + 1) * q_block - 1) // kv_block
            s0 = min(max(end_b - nw + 1, 0), nk - nw)
        m_run = torch.full((B, H, q_block), NEG_INF, dtype=torch.float32, device=dev)
        l_run = torch.zeros((B, H, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, q_block, Dv), dtype=torch.float32, device=dev)
        for j in range(s0, s0 + nw):
            sl = slice(j * kv_block, (j + 1) * kv_block)
            s = torch.einsum("bqgrd,bkgd->bgrqk", q_i, k[:, sl].float()).reshape(
                B, H, q_block, kv_block) * scale
            s = softcap(s, cap)
            kp = torch.arange(sl.start, sl.stop, device=dev)[None, :]
            msk = torch.ones((q_block, kv_block), dtype=torch.bool, device=dev)
            if causal:
                msk = msk & (kp <= qp)
            if window > 0:
                msk = msk & ((qp - kp) < window)
            s = torch.where(msk, s, torch.tensor(NEG_INF, dtype=s.dtype, device=dev))
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            corr = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * corr + p.sum(dim=-1)
            pv = torch.einsum("bgrqk,bkgd->bgrqd", p.to(q.dtype).reshape(B, KV, rep, q_block, kv_block),
                              v[:, sl]).reshape(B, H, q_block, Dv)
            acc = acc * corr[..., None] + pv.float()
            m_run = m_new
        out = (acc / torch.clamp(l_run, min=1e-37)[..., None]).to(q.dtype)
        outs.append(out.transpose(1, 2))             # (B, q_block, H, Dv)
    return torch.cat(outs, dim=1)


def _attend(q, k, v, cfg: ModelConfig, *, causal: bool, window: int):
    """Softmax attention of q (B, Sq, H, D) over k (B, Sk, KV, D) and
    v (B, Sk, KV, Dv), scaled by D^-0.5 (D = head_dim, or MLA's nope +
    rope width): the flash kernel on the card; the reference's route on
    the host."""
    Sq, Sk = q.shape[1], k.shape[1]
    cap = cfg.attn_logit_softcap
    if q.device.type == "cpu":
        # a window marks a local layer: only worth banding when ≥ ¾ of the
        # key blocks drop out (the reference's rule)
        banded = 0 < window and window * 8 <= Sk
        if banded or max(Sq, Sk) > CHUNKED_THRESHOLD:
            return _chunked(q, k, v, causal=causal, window=window, cap=cap,
                            scale=q.shape[-1] ** -0.5, banded=banded)
    return flash_attention(q, k, v, causal=causal, window=window, softcap=cap)


def attention(params, x: torch.Tensor, cfg: ModelConfig, *, is_global: bool = True,
              causal: bool = True, kv_x: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill): x (B, S, d) → (B, S, d).

    Self-attention (``kv_x`` None) takes rotary embeddings, causal or not
    (whisper's encoder is not); a local layer (``is_global`` False) sees
    the last ``cfg.local_window`` keys. Cross-attention over ``kv_x``
    (B, Sk, d) takes neither rotary embeddings nor a window, but does
    take ``cfg.attn_logit_softcap``, as the reference's prefill does (its
    cross decode does not: ``cross_decode``)."""
    B, S, _ = x.shape
    q, k, v = _project(params, x, cfg, kv_x)
    if causal or kv_x is None:          # self-attention → rotary
        theta = rope_theta(cfg, is_global)
        positions = torch.arange(S, device=x.device).expand(B, S)
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    window = 0 if (is_global or kv_x is not None) else cfg.local_window
    o = _attend(q, k, v, cfg, causal=causal, window=window)
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


def cross_kv(params, src: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """A cross layer's fixed keys and values from its source (image
    embeddings or the encoder's output) src (B, N, d) → (B, N, KV, D)
    each: no rotary embedding, no QK-norm (the reference's cache does
    neither)."""
    KV, D = cfg.num_kv_heads, cfg.head_dim_
    return _heads(src, params["wk"], KV, D), _heads(src, params["wv"], KV, D)


def cross_decode(params, x_t: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """One token over a cross layer's fixed keys and values (B, N, KV, D)
    → (B, 1, d): every key visible (position N − 1, no window). As in the
    reference's ``_cross_attend``, the query takes no rotary embedding and
    no QK-norm, and the scores no soft-cap."""
    q = _heads(x_t, params["wq"], cfg.num_heads, cfg.head_dim_)[:, 0]
    o = decode_attention_kernel(q, ck, cv, ck.shape[1] - 1, window=0, softcap=0.0)
    return _out(params, o[:, None], cfg)


# -- the sharded decode ------------------------------------------------------------

def current_mesh():
    """``runtime.pspec.current_mesh()`` (imported here at call time:
    ``runtime`` imports the models)."""
    from ..runtime.pspec import current_mesh as _current

    return _current()


def sharded_decode_on() -> bool:
    """The reference's baseline switch: ``REPRO_SHARDED_DECODE=0`` turns the
    sharded decode bodies off (``models.decode`` then gathers a layer's
    blocks at use)."""
    return os.environ.get("REPRO_SHARDED_DECODE", "1") != "0"


def _decode_bspec(mesh, B: int):
    """The mesh axes the global batch B shards over in the decode bodies:
    ('pod', 'data') where both divide it, else ('data',), else None."""
    has_pod = mesh.get("pod", 1) > 1
    bax = ("pod", "data") if has_pod else ("data",)
    pd = math.prod(mesh.get(a, 1) for a in bax)
    if B > 1 and B % pd == 0:
        return bax
    if B > 1 and B % mesh.get("data", 1) == 0:
        return ("data",)
    return None


def _psum_proj(x, w, d: int, mesh, axis: str = "data"):
    """Weight-stationary projection: x (B, 1, d) at full d times w
    (d_loc, …), this rank's shard of the input dimension over ``axis``,
    summed over the axis (``layers.row_parallel``: float32 partials, one
    rounding): only the (B, 1, ·) products move. x must hold the same rows
    on every rank of ``axis`` (gather the batch first)."""
    d_loc = w.shape[0]
    if d_loc == d:
        return linear(x, w.reshape(d, -1)).reshape(*x.shape[:-1], *w.shape[1:])
    r = mesh.coords[axis]
    y = row_parallel(x[..., r * d_loc:(r + 1) * d_loc], w.reshape(d_loc, -1), mesh, axis)
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def _gather_batch(x, bspec, mesh):
    """The (tiny) decode activations of every row of the batch axes, so
    that weight-stationary partial products see every row."""
    for ax in reversed(bspec or ()):
        x = all_gather(x, ax, mesh, dim=0)
    return x


def _batch_row_start(mesh, bspec, B_loc: int) -> int:
    """This rank's first row of the global batch: its coordinates on the
    batch axes row-major (pod before data), times its rows."""
    idx = 0
    for ax in (bspec or ()):
        idx = idx * mesh[ax] + mesh.coords[ax]
    return idx * B_loc


def _own_rows(y, mesh, bspec, B_loc: int):
    """This rank's rows of y, which holds every row of the batch axes."""
    r0 = _batch_row_start(mesh, bspec, B_loc)
    return y[r0:r0 + B_loc]


def col_proj(x, ws, d: int, mesh, bspec) -> list:
    """x (B_loc, 1, d), this rank's rows, times each w of ``ws`` (d_loc, …),
    held whole along d or cut over 'data': a cut one weight-stationary
    (``_psum_proj`` on the rows of the batch axes, gathered once, and the
    rank's rows kept), so that no weight moves."""
    if all(w.shape[0] == d for w in ws):
        return [_psum_proj(x, w, d, mesh) for w in ws]
    xg = _gather_batch(x, bspec, mesh)
    return [_own_rows(_psum_proj(xg, w, d, mesh), mesh, bspec, x.shape[0]) for w in ws]


def row_proj(y, w, d: int, mesh, bspec, *, cut: bool):
    """y (B_loc, 1, k) times w (k, d_loc): row-parallel where ``cut`` (k is
    this rank's block over 'model'; the float32 partial products summed
    over 'model' and rounded once, ``layers.row_parallel``); where w's
    output dimension is cut over 'data', on the rows of the batch axes and
    gathered back along d over 'data', the rank's rows kept → (B_loc, 1, d)."""
    prod = (lambda a: row_parallel(a, w, mesh)) if cut else (lambda a: linear(a, w))  # noqa: E731
    if w.shape[-1] == d:
        return prod(y)
    z = all_gather(prod(_gather_batch(y, bspec, mesh)), "data", mesh, dim=-1)
    return _own_rows(z, mesh, bspec, y.shape[0])


def _rows(mesh, batch: int, bspec) -> int:
    """A rank's rows of the global batch under ``bspec``."""
    n = math.prod(mesh[a] for a in (bspec or ()))
    if batch % n:
        raise ValueError(f"batch {batch} does not divide over {bspec}")
    return batch // n


def decode_attention_specs(cfg: ModelConfig, mesh, B: int) -> dict:
    """The reference's in_specs of ``decode_attention_sharded``'s body for
    the global batch B: a rank's blocks of x (B, 1, d), of the projections
    (the input dimension over 'data' where it divides, the heads over
    'model' where they divide; wo the other way round) and of each cache
    (B, S, KV, D): rows over the batch axes, S over 'model' (the QK-norm
    scales are whole). The function reads its blocks by them; the serve
    step holds the rules' blocks, which a body reads through views."""
    bspec = _decode_bspec(mesh, B)
    m, dsz = mesh.get("model", 1), mesh.get("data", 1)
    d_ax = "data" if (dsz > 1 and cfg.d_model % dsz == 0) else None
    h_ax = "model" if cfg.num_heads % m == 0 else None
    kv_ax = "model" if cfg.num_kv_heads % m == 0 else None
    return {"x": (bspec, None, None), "wq": (d_ax, h_ax, None), "wk": (d_ax, kv_ax, None),
            "wv": (d_ax, kv_ax, None), "wo": (h_ax, None, d_ax), "cache": (bspec, "model", None, None)}


def _whole_heads(q, n: int, mesh):
    """q (B_loc, 1, n_loc, D), this rank's heads of n, gathered over 'model'."""
    return q if q.shape[2] == n else all_gather(q, "model", mesh, dim=2)


def _write_block(cache, t, slot: int, cut, mesh) -> None:
    """Write the token's row t (B_loc, …) at global ``slot`` into this
    rank's block of a layer's cache (B, S, …): whole (``cut`` None), cut
    along S over 'model' (``cut`` 1: only the shard that owns the slot
    writes), along its rows (0: the rank's rows of t) or along a later
    dimension (the rank's slice of t there)."""
    if cut == 1:
        s = slot - mesh.coords["model"] * cache.shape[1]
        if 0 <= s < cache.shape[1]:
            cache[:, s] = t.to(cache.dtype)
        return
    if cut is not None:
        n = cache.shape[cut]
        t = t.narrow(0 if cut == 0 else cut - 1, mesh.coords["model"] * n, n)
    cache[:, slot] = t.to(cache.dtype)


def _d_block_attention(q, ck, cv, pos: int, mesh, *, window: int = 0, softcap: float = 0.0):
    """One-token attention of q (B_loc, H, D), whole, over keys and values
    (B_loc, S, KV, D_loc) cut along D over 'model' (the rank's slice
    coordinate('model') · D_loc onward), keys 0…pos visible (within
    ``window`` of pos where it is > 0): the float32 partial scores of the
    rank's slice summed over 'model' and scaled by the whole D's D^-0.5,
    the soft-cap, the mask, the softmax, and the rank's slice of the
    output gathered along D → (B_loc, H, D) in q's type. No kernel: the
    decode kernel needs whole rows of D for its scores (the reference's
    model runs stock products here too)."""
    B, H, D = q.shape
    KV, Dl = ck.shape[2], ck.shape[3]
    r = mesh.coords["model"]
    qg = q[..., r * Dl:(r + 1) * Dl].reshape(B, KV, H // KV, Dl)
    s = all_reduce(torch.einsum("bgrd,bkgd->bgrk", qg.float(), ck.float()), "model", mesh) * D ** -0.5
    warm_host_math(s)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    idx = torch.arange(ck.shape[1], device=q.device)
    valid = idx <= pos
    if window > 0:
        valid = valid & ((pos - idx) < window)
    s = torch.where(valid, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1).masked_fill(~valid, 0.0).to(q.dtype)
    o = torch.einsum("bgrk,bkgd->bgrd", p, cv.to(q.dtype)).reshape(B, H, Dl)
    return all_gather(o, "model", mesh, dim=2)


def decode_attention_block(q, ck, cv, pos: int, cut, mesh, *, window: int = 0, softcap: float = 0.0):
    """One-token attention of this rank's rows' queries q (B_loc, H, D),
    whole, over its block ck, cv of a layer's cache (B_loc, S, KV, D), cut
    over 'model' along dimension ``cut`` → (B_loc, H, D) in q's type, the
    same on every rank of 'model'. Only one-token results move:

      None  whole: the decode kernel;
      1     along S: keys coordinate('model') · S_loc onward through the
            kernel's key-range entry (``key0``, ``lse``), the ranks'
            (out, lse) pairs combined, M = max lse, w = e^(lse − M),
            out = Σ w·out / Σ w, the reference's pmax and two psums;
      0     along the rows: the kernel on the rank's rows of q and of the
            cache, the outputs gathered along the rows;
      3     along D: ``_d_block_attention``."""
    if cut is None:
        return decode_attention_kernel(q, ck, cv, pos, window=window, softcap=softcap)
    if cut == 0:
        n, r = ck.shape[0], mesh.coords["model"]
        o = decode_attention_kernel(q[r * n:(r + 1) * n], ck, cv, pos, window=window, softcap=softcap)
        return all_gather(o, "model", mesh, dim=0)
    if cut == 3:
        return _d_block_attention(q, ck, cv, pos, mesh, window=window, softcap=softcap)
    if cut != 1:
        raise ValueError(f"decode_attention_block: a cache cut along dimension {cut} over 'model' (no body reads it)")
    o, lse = decode_attention_kernel(q, ck, cv, pos, window=window, softcap=softcap,
                                     key0=mesh.coords["model"] * ck.shape[1], lse=True)
    M = all_reduce(lse, "model", mesh, op="max")
    M = torch.where(torch.isfinite(M), M, torch.zeros_like(M))
    w = torch.exp(lse - M)
    l = all_reduce(w, "model", mesh)
    acc = all_reduce(w[..., None] * o, "model", mesh)
    return (acc / l[..., None]).to(q.dtype)


def _out_proj(wo, o, d: int, mesh, bspec):
    """The attention output o (B_loc, 1, H, D), whole on every rank of
    'model', through this rank's block of wo (H_loc, D, d_loc): its heads
    row-parallel (``row_proj``) → (B_loc, 1, d)."""
    H, D = o.shape[2], o.shape[3]
    H_loc = wo.shape[0]
    if H_loc != H:
        r = mesh.coords["model"]
        o = o[:, :, r * H_loc:(r + 1) * H_loc]
    return row_proj(o.reshape(*o.shape[:2], H_loc * D), wo.reshape(H_loc * D, -1), d, mesh, bspec, cut=H_loc != H)


def _check_rows(what: str, mesh, batch: int, bspec, x_t, cache, cut) -> int:
    """This rank's rows of the global batch; raises where x_t or the cache
    block (its rows cut over 'model' too where ``cut`` is 0) holds others."""
    Bl = _rows(mesh, batch, bspec)
    want = Bl // mesh.get("model", 1) if cut == 0 else Bl
    if x_t.shape[0] != Bl or cache.shape[0] != want:
        raise ValueError(f"{what}: rows {x_t.shape[0]} and a cache of {cache.shape[0]} rows, for a global batch "
                         f"{batch} over {bspec}")
    return Bl


def decode_attention_sharded(params, x_t: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                             cfg: ModelConfig, *, batch: int, is_global: bool = True, ring: bool = False,
                             cut: int | None = 1):
    """Weight-stationary decode attention on this rank's blocks
    (``decode_attention_specs`` for the global batch ``batch``): x_t
    (B_loc, 1, d), the projections' blocks in ``params``, and this layer's
    cache block of (B, S, KV, D), linear or a ring, whole (``cut`` None) or
    cut over 'model' along S (``cut`` 1: keys coordinate('model') · S_loc
    onward, of a ring its slots), its rows (0) or D (3); a cut along the
    kv heads raises. Writes the token's key and value into the block that
    holds them (the slot's shard, the rank's rows, its slice of D), in
    place, and returns (out (B_loc, 1, d), cache_k, cache_v).

    The projections' partial products are summed over the weights' 'data'
    shard of d and the heads gathered over 'model' (one-token rows only);
    the attention runs on the block (``decode_attention_block``: along S
    through the decode kernel's key-range entry and the ranks' (out, lse)
    pairs combined, along the rows through the kernel on the rank's rows,
    along D on float32 partial scores), and wo row-parallel over the
    heads."""
    mesh = current_mesh()
    if cut not in (None, 0, 1, 3):
        raise ValueError(f"decode_attention_sharded: a self-attention cache cut along dimension {cut} over "
                         f"'model' (no sharded body reads it)")
    bspec = _decode_bspec(mesh, batch)
    Bl = _check_rows("decode_attention_sharded", mesh, batch, bspec, x_t, cache_k, cut)
    H, KV, D, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, cfg.d_model
    S = cache_k.shape[1] * (mesh.get("model", 1) if cut == 1 else 1)
    if pos < 0 or (not ring and pos >= S):
        raise ValueError(f"decode_attention_sharded: pos {pos} outside a {'ring' if ring else 'linear cache'} of {S}")
    q, kt, vt = col_proj(x_t, [params["wq"], params["wk"], params["wv"]], d, mesh, bspec)
    q, kt, vt = _whole_heads(q, H, mesh), _whole_heads(kt, KV, mesh), _whole_heads(vt, KV, mesh)
    if cfg.qk_norm:
        q = _qk_norm(q, params["q_norm"])
        kt = _qk_norm(kt, params["k_norm"])
    theta = rope_theta(cfg, is_global)
    posb = torch.full((Bl, 1), pos, dtype=torch.int64, device=x_t.device)
    q = rope(q, posb, theta)[:, 0]
    kt = rope(kt, posb, theta)
    slot = pos % S if ring else pos                    # a ring's slot wraps
    _write_block(cache_k, kt[:, 0], slot, cut, mesh)
    _write_block(cache_v, vt[:, 0], slot, cut, mesh)
    # a ring's slot j holds position pos − ((pos − j) mod W): visible iff j ≤ min(pos, W − 1)
    read, window = (min(pos, S - 1), 0) if ring else (pos, 0 if is_global else cfg.local_window)
    o = decode_attention_block(q, cache_k, cache_v, read, cut, mesh, window=window,
                               softcap=cfg.attn_logit_softcap)
    decode_attention_sharded.calls += 1
    return _out_proj(params["wo"], o[:, None], d, mesh, bspec), cache_k, cache_v


def cross_decode_sharded(params, x_t: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, cfg: ModelConfig, *,
                         batch: int, cut: int | None):
    """``cross_decode`` on this rank's blocks: x_t (B_loc, 1, d), wq and wo
    cut as ``decode_attention_specs`` reads them (heads over 'model'), and
    the cross layer's fixed keys and values (B, N, KV, D) as this rank's
    block, cut over 'model' along dimension ``cut`` (``decode_attention_block``
    with N in place of S, every key visible) → (B_loc, 1, d).
    No rotary embedding, QK-norm or soft-cap, as the reference's cross
    decode has none."""
    mesh = current_mesh()
    bspec = _decode_bspec(mesh, batch)
    _check_rows("cross_decode_sharded", mesh, batch, bspec, x_t, ck, cut)
    H, d = cfg.num_heads, cfg.d_model
    q = _whole_heads(col_proj(x_t, [params["wq"]], d, mesh, bspec)[0], H, mesh)
    N = ck.shape[1] * (mesh["model"] if cut == 1 else 1)
    o = decode_attention_block(q[:, 0], ck, cv, N - 1, cut, mesh)              # every key visible
    cross_decode_sharded.calls += 1
    return _out_proj(params["wo"], o[:, None], d, mesh, bspec)


def decode_mlp_specs(cfg: ModelConfig, mesh, B: int, d_ff: int | None = None) -> dict:
    """The reference's in_specs of ``decode_mlp_sharded``'s body: x
    (B, 1, d) by rows; w_gate, w_up (d, f) with d over 'data' and f over
    'model' where they divide; w_down (f, d) the other way round. ``d_ff``
    is f where it is not ``cfg.d_ff`` (the moe family's shared experts)."""
    bspec = _decode_bspec(mesh, B)
    m, dsz = mesh.get("model", 1), mesh.get("data", 1)
    d_ax = "data" if (dsz > 1 and cfg.d_model % dsz == 0) else None
    f_ax = "model" if (m > 1 and (d_ff or cfg.d_ff) % m == 0) else None
    return {"x": (bspec, None, None), "w_gate": (d_ax, f_ax), "w_up": (d_ax, f_ax), "w_down": (f_ax, d_ax)}


def decode_mlp_sharded(p, x: torch.Tensor, cfg: ModelConfig, *, batch: int, kind: str | None = None,
                       d_ff: int | None = None) -> torch.Tensor:
    """Weight-stationary decode MLP on this rank's blocks
    (``decode_mlp_specs``): x (B_loc, 1, d) → (B_loc, 1, d). The 2-D-sharded
    weights stay where they are; only (B, 1, ·) activations are summed or
    gathered across the mesh. ``kind`` and ``d_ff`` where they are not the
    config's (the moe family's shared experts: SwiGLU of their width)."""
    mesh = current_mesh()
    d, f, kind = cfg.d_model, d_ff or cfg.d_ff, kind or cfg.mlp
    bspec = _decode_bspec(mesh, batch)
    if x.shape[0] != _rows(mesh, batch, bspec):
        raise ValueError(f"decode_mlp_sharded: {x.shape[0]} rows for a global batch {batch} over {bspec}")
    warm_host_math(x)
    if kind in ("swiglu", "geglu"):
        g, u = col_proj(x, [p["w_gate"], p["w_up"]], d, mesh, bspec)
        act = (F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")) * u
    elif kind in ("squared_relu", "gelu"):
        u, = col_proj(x, [p["w_up"]], d, mesh, bspec)
        act = torch.square(F.relu(u)) if kind == "squared_relu" else F.gelu(u, approximate="tanh")
    else:
        raise ValueError(kind)
    wdn = p["w_down"]                                   # (f_loc, d_loc): f over 'model', the row-parallel sum
    decode_mlp_sharded.calls += 1
    return row_proj(act, wdn, d, mesh, bspec, cut=wdn.shape[0] != f)


decode_attention_sharded.calls = 0   # layers run through the sharded attention, this process
cross_decode_sharded.calls = 0       # cross layers run through the sharded cross attention, this process
decode_mlp_sharded.calls = 0


# -- the sharded full-sequence attention and MLP -------------------------------------

def _local_kv(k, H: int, H_loc: int, h0: int):
    """The kv heads that query heads h0 … h0 + H_loc − 1 read, of k (B, S, KV,
    D) holding all KV heads: a slice where the rank's heads cover whole kv
    groups (or lie in one), else each query head's own copy (rep 1)."""
    KV = k.shape[2]
    rep = H // KV
    if H_loc % rep == 0:
        return k[:, :, h0 // rep:(h0 + H_loc) // rep]
    if rep % H_loc == 0:
        return k[:, :, h0 // rep:h0 // rep + 1]
    return k.repeat_interleave(rep, dim=2)[:, :, h0:h0 + H_loc]


def attention_sharded(params, x: torch.Tensor, cfg: ModelConfig, mesh, specs: dict, *,
                      is_global: bool = True, causal: bool = True, kv_x: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence attention of a rank's rows x (B_loc, S, d) on its
    blocks, cut by ``specs`` (name → spec, ``runtime.sharding.param_specs``'):
    the projections' 'data' blocks gathered whole along d, the rank's query
    heads and the kv heads they read through the flash kernel (forward, and
    backward through ``FlashAttentionFn``), the row-parallel output summed
    over 'model' → (B_loc, S, d), the same on every rank of 'model'.

    ``causal`` and ``kv_x`` as ``attention``'s: self-attention (``kv_x``
    None) takes rotary embeddings, causal or not, and a local layer's
    window; cross-attention projects its keys and values from ``kv_x``
    (B_loc, Sk, d), the rank's rows of the image embeddings or of the
    encoder's output, and takes neither."""
    attention_sharded.calls += 1
    H, D, d = cfg.num_heads, cfg.head_dim_, cfg.d_model
    w = {n: gather_dims(params[n], specs[n], mesh, axes=("data",)) for n in ("wq", "wk", "wv", "wo")}
    H_loc, KV_loc = w["wq"].shape[1], w["wk"].shape[1]
    B, S, _ = x.shape
    src = x if kv_x is None else kv_x
    q = _heads(x, w["wq"], H_loc, D)
    k = _heads(src, w["wk"], KV_loc, D)
    v = _heads(src, w["wv"], KV_loc, D)
    if cfg.qk_norm:
        q = _qk_norm(q, params["q_norm"])
        k = _qk_norm(k, params["k_norm"])
    if causal or kv_x is None:          # self-attention → rotary
        theta = rope_theta(cfg, is_global)
        positions = torch.arange(S, device=x.device).expand(B, S)
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    if H_loc != H and KV_loc == cfg.num_kv_heads:   # the heads are cut, the kv heads whole
        h0 = mesh.coords["model"] * H_loc
        k, v = _local_kv(k, H, H_loc, h0), _local_kv(v, H, H_loc, h0)
    window = 0 if (is_global or kv_x is not None) else cfg.local_window
    o = _attend(q, k, v, cfg, causal=causal, window=window).reshape(B, S, H_loc * D)
    wo = w["wo"].reshape(H_loc * D, d)
    return linear(o, wo) if H_loc == H else row_parallel(o, wo, mesh)


def mlp_sharded(p, x: torch.Tensor, cfg: ModelConfig, mesh, specs: dict, *, kind: str | None = None) -> torch.Tensor:
    """The MLP (``kind``, by default ``cfg.mlp``; the moe family's shared
    experts are a SwiGLU MLP) of a rank's rows x (B_loc, S, d) on its
    blocks, cut by ``specs``: the 'data' blocks gathered whole along d, the
    rank's ff columns, the row-parallel w_down's partial output summed
    over 'model' (a width the rules leave whole runs whole)."""
    mlp_sharded.calls += 1
    w = {n: gather_dims(p[n], specs[n], mesh, axes=("data",)) for n in specs}
    h = mlp_hidden(w, x, kind or cfg.mlp)
    cut = "model" in spec_axes(specs["w_down"][0]) and mesh.get("model", 1) > 1
    return row_parallel(h, w["w_down"], mesh) if cut else linear(h, w["w_down"])


attention_sharded.calls = 0   # calls of the sharded full-sequence attention (remat's recompute too), this process
mlp_sharded.calls = 0
