"""Mamba-2 (SSD — state-space duality) block, the port of
``repro.models.ssm``.

Prefill uses the chunked SSD algorithm: within-chunk terms are a masked
(decay-weighted) attention-like quadratic over the chunk, and
cross-chunk terms flow through a linear recurrence over chunk states
(the reference's ``lax.scan`` over chunks is a loop over the S/Q chunks
here). Decode is the pure recurrence with an (H, P, N) state and a small
causal-conv cache, updated in place. The state, the step sizes and the
decays are float32 and the products in the compute type, with the
reference's casts in the reference's order. No kernel: every operation
is a stock PyTorch one.

``mamba_sharded`` runs the block on a rank's rows and its blocks under a
mesh placed over a process group (training and prefill), cut by
``runtime.sharding.param_specs``: in_proj (d, z | x | B | C | dt) by its
columns over 'model' and d over 'data', conv_w by its channels, out_proj
(din, d) by its rows. A contiguous cut of in_proj crosses its sections,
so in_proj and conv_w are gathered whole (their gradients
reduce-scattered back) and each rank takes the columns of its H/m heads
of z, x and dt and the groups of B and C that they read: it convolves
and scans those heads, sums the gated norm's float32 squares over
'model', and applies its rows of out_proj row-parallel. A head count
that does not divide 'model' runs whole on every rank.

``mamba_decode_sharded`` is the one-token decode on a rank's rows under a
placed mesh (``models.decode``), each cache read where the rules cut it:
in_proj column-parallel with the (B, 1, ·) projections gathered over
'model', the conv on the rank's block of ``conv`` (its channels, or its
rows), the state updated on the rank's block of ``state`` (its rows,
heads, head columns or N-block), y's partial sums over N summed over
'model' in float32 (or its blocks gathered), out_proj row-parallel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .._device import warm_host_math
from ..launch.mesh import all_gather, all_reduce, gather_dims, spec_axes
from .attention import _decode_bspec, col_proj, row_proj
from .common import ModelConfig
from .layers import init_linear_, rms_norm, row_parallel

__all__ = ["init_mamba", "init_mamba_", "mamba_forward", "mamba_decode", "init_mamba_cache", "mamba_sharded",
           "mamba_decode_sharded"]


def init_mamba(cfg: ModelConfig, device) -> nn.ParameterDict:
    """Uninitialised parameters (``init_mamba_`` fills them), in the
    reference's layouts: in_proj (d, 2·din + 2·G·N + H); conv_w (W, conv_dim);
    conv_b (conv_dim,), A_log, D, dt_bias (H,) and norm (din,) float32;
    out_proj (din, d)."""
    d, din, H, N, G = cfg.d_model, cfg.d_inner, cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_ngroups
    conv_dim = din + 2 * G * N
    dt, f32 = cfg.pdtype, torch.float32
    shapes = {"in_proj": ((d, 2 * din + 2 * G * N + H), dt),
              "conv_w": ((cfg.ssm_conv_width, conv_dim), dt), "conv_b": ((conv_dim,), f32),
              "A_log": ((H,), f32), "D": ((H,), f32), "dt_bias": ((H,), f32),
              "norm": ((din,), f32), "out_proj": ((din, d), dt)}
    return nn.ParameterDict({
        n: nn.Parameter(torch.empty(s, dtype=t, device=device), requires_grad=False)
        for n, (s, t) in shapes.items()})


@torch.no_grad()
def init_mamba_(p: nn.ParameterDict, cfg: ModelConfig, generator: torch.Generator) -> None:
    H = cfg.ssm_nheads
    init_linear_(p["in_proj"], cfg.d_model, generator)
    init_linear_(p["conv_w"], 1, generator, scale=0.02)
    p["conv_b"].zero_()
    p["A_log"].copy_(torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32)))
    p["D"].fill_(1.0)
    p["dt_bias"].zero_()
    p["norm"].zero_()
    init_linear_(p["out_proj"], cfg.d_inner, generator)


def _split(cfg: ModelConfig, zxbcdt: torch.Tensor):
    din, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
    c = 2 * din + 2 * G * N
    return zxbcdt[..., :din], zxbcdt[..., din:c], zxbcdt[..., c:]


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence and its SiLU, rounded to
    xBC's type once (as ``rglru._conv``: XLA keeps the fused chain in
    float32 under ``jit``). xBC (B, S, Cd); w (W, Cd)."""
    W, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC.float(), (0, 0, W - 1, 0))
    w = w.to(xBC.dtype).float()
    out = sum(pad[:, i : i + S, :] * w[i][None, None, :] for i in range(W))
    return F.silu(out + b[None, None, :].to(xBC.dtype).float()).to(xBC.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular cumulative sums: out[..., i, j] = Σ_{j<k≤i} x[k],
    −inf above the diagonal (so that exp gives 0 there)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, torch.tensor(-math.inf, dtype=seg.dtype, device=x.device))


def _rep(x: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(x, rep, axis=dim)``: group g feeds heads g·rep … g·rep + rep − 1."""
    return x if rep == 1 else torch.repeat_interleave(x, rep, dim=dim)


def mamba_forward(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Chunked SSD. x (B, S, d) → (B, S, d). S must divide by the chunk
    min(ssm_chunk, S)."""
    warm_host_math(x)
    zxbcdt = x @ params["in_proj"]
    z, xBC, dt_raw = _split(cfg, zxbcdt)
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    y = _ssd(xBC, dt_raw, params["A_log"], params["D"], params["dt_bias"], cfg)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm"])
    return y @ params["out_proj"]


def _ssd(xBC: torch.Tensor, dt_raw: torch.Tensor, A_log, D, dt_bias, cfg: ModelConfig) -> torch.Tensor:
    """The chunked SSD of H heads (H = dt_raw's width) reading G groups of
    B and C (head h the group h // (H / G)): the conv outputs xBC
    (B, S, H·P + 2·G·N), the step sizes' pre-activations dt_raw (B, S, H)
    and the heads' A_log, D, dt_bias (H,) → y (B, S, H·P) before the gate."""
    Bsz, S, _ = xBC.shape
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    H = dt_raw.shape[-1]
    din = H * P
    G = (xBC.shape[-1] - din) // (2 * N)
    Q = min(cfg.ssm_chunk, S)
    if S % Q:                       # the reference's assertion, kept under -O
        raise ValueError(f"mamba_forward: S {S} is not a multiple of the chunk {Q}")
    nc = S // Q
    dt_x = xBC.dtype

    xs, Bmat, Cmat = xBC[..., :din], xBC[..., din:din + G * N], xBC[..., din + G * N:]
    xs = xs.reshape(Bsz, S, H, P)
    dt = F.softplus(dt_raw.float() + dt_bias)                                 # (B, S, H)
    A = -torch.exp(A_log)                                                    # (H,)
    dA = dt * A[None, None, :]                                               # (B, S, H)

    # chunk everything: (B, nc, Q, ...)
    xs_c = xs.reshape(Bsz, nc, Q, H, P)
    B_c = Bmat.reshape(Bsz, nc, Q, G, N)
    C_c = Cmat.reshape(Bsz, nc, Q, G, N)
    dt_c = dt.reshape(Bsz, nc, Q, H)
    dA_c = dA.reshape(Bsz, nc, Q, H)

    # ---- intra-chunk (diagonal blocks): decay-masked attention ----
    L = torch.exp(_segsum(dA_c.permute(0, 1, 3, 2)))               # (B, nc, H, Q, Q)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", C_c, B_c)          # (B, nc, G, Q, Q)
    rep = H // G
    scores = _rep(scores, rep, 2)                                  # (B, nc, H, Q, Q)
    att = (scores * L).to(dt_x)
    xdt = xs_c * dt_c[..., None].to(dt_x)                          # (B, nc, Q, H, P)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", att, xdt)

    # ---- chunk states & inter-chunk recurrence ----
    seg_end = torch.cumsum(dA_c, dim=2)                            # (B, nc, Q, H)
    decay_to_end = torch.exp(seg_end[:, :, -1:, :] - seg_end)      # (B, nc, Q, H)
    B_rep = _rep(B_c, rep, 3)                                      # (B, nc, Q, H, N)
    states = torch.einsum("bcqhn,bcqhp->bchpn", B_rep,
                          xdt * decay_to_end[..., None].to(dt_x))  # (B, nc, H, P, N)
    chunk_decay = torch.exp(seg_end[:, :, -1, :])                  # (B, nc, H)

    carry = torch.zeros((Bsz, H, P, N), dtype=dt_x, device=xBC.device)
    prev = []
    for c in range(nc):                                            # the state BEFORE chunk c
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None].to(carry.dtype) + states[:, c]
    prev_states = torch.stack(prev, dim=1)                         # (B, nc, H, P, N)

    # ---- off-diagonal contribution: C · decayed previous state ----
    decay_from_start = torch.exp(seg_end)                          # (B, nc, Q, H)
    C_rep = _rep(C_c, rep, 3)                                      # (B, nc, Q, H, N)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", C_rep, prev_states)
    y_off = y_off * decay_from_start[..., None].to(dt_x)

    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    y = y + xs * D[None, None, :, None].to(dt_x)
    return y.reshape(Bsz, S, din)


def mamba_sharded(params, x: torch.Tensor, cfg: ModelConfig, mesh, specs: dict) -> torch.Tensor:
    """``mamba_forward`` of a rank's rows x (B_loc, S, d) on its blocks, cut
    by ``specs`` (name → spec): in_proj and conv_w gathered whole, the
    rank's H/m heads' columns of z, x and dt and the B and C groups they
    read convolved and scanned, the gated norm's mean square over din from
    the float32 sums of squares summed over 'model', the rank's rows of
    out_proj row-parallel → (B_loc, S, d), the same on every rank of
    'model'. Where H does not divide 'model' (or a rank's heads would
    straddle the groups of B and C) the block runs whole on every rank."""
    mamba_sharded.calls += 1
    din, H, P, N, G = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_ngroups
    m = mesh.get("model", 1)
    rep = H // G
    H_loc = H // m
    if H % m or "model" not in spec_axes(specs["out_proj"][0]) or (H_loc % rep and rep % H_loc):
        return mamba_forward({n: gather_dims(t, specs[n], mesh) for n, t in params.items()}, x, cfg)
    h0 = mesh.coords["model"] * H_loc
    g0, g1 = h0 // rep, (h0 + H_loc - 1) // rep + 1
    dev = x.device
    heads = torch.arange(h0 * P, (h0 + H_loc) * P, device=dev)
    groups = torch.arange(g0 * N, g1 * N, device=dev)
    conv_cols = torch.cat([heads, din + groups, din + G * N + groups])
    cols = torch.cat([heads, din + conv_cols, 2 * din + 2 * G * N + torch.arange(h0, h0 + H_loc, device=dev)])
    w_in = gather_dims(params["in_proj"], specs["in_proj"], mesh).index_select(1, cols)
    w_conv = gather_dims(params["conv_w"], specs["conv_w"], mesh).index_select(1, conv_cols)
    warm_host_math(x)
    zxbcdt = x @ w_in
    c_loc = H_loc * P
    z, xBC, dt_raw = zxbcdt[..., :c_loc], zxbcdt[..., c_loc:-H_loc], zxbcdt[..., -H_loc:]
    xBC = _causal_conv(xBC, w_conv, params["conv_b"][conv_cols])
    hs = slice(h0, h0 + H_loc)
    y = _ssd(xBC, dt_raw, params["A_log"][hs], params["D"][hs], params["dt_bias"][hs], cfg)
    # the gated rms_norm over the whole din: float32 squares summed over 'model'
    g = (y * F.silu(z.float()).to(y.dtype)).float()
    var = all_reduce(torch.sum(torch.square(g), dim=-1, keepdim=True), "model", mesh) / din
    g = (g * torch.rsqrt(var + 1e-6) * (1.0 + params["norm"][h0 * P:(h0 + H_loc) * P].float())).to(y.dtype)
    return row_parallel(g, gather_dims(params["out_proj"], specs["out_proj"], mesh, axes=("data",)), mesh)


mamba_sharded.calls = 0   # calls of the sharded Mamba-2 block (remat's recompute too), this process


def init_mamba_cache(cfg: ModelConfig, batch: int, layers: int, dtype=None, device=None) -> dict:
    dt = dtype or cfg.cdtype
    din, H, P, N, G = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_ngroups
    conv_dim = din + 2 * G * N
    return {
        "conv": torch.zeros((layers, batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dt, device=device),
        "state": torch.zeros((layers, batch, H, P, N), dtype=torch.float32, device=device),
    }


def mamba_decode(params, x_t: torch.Tensor, conv_cache: torch.Tensor, state: torch.Tensor,
                 cfg: ModelConfig):
    """One-token recurrence. x_t (B, 1, d); conv_cache (B, W − 1, conv_dim);
    state (B, H, P, N) float32. Returns (y, conv_cache, state), the caches
    updated in place."""
    Bsz = x_t.shape[0]
    din, H, P, N, G = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_ngroups
    warm_host_math(x_t)
    zxbcdt = x_t @ params["in_proj"]
    z, xBC_t, dt_raw = _split(cfg, zxbcdt)                         # (B, 1, ·)
    # causal conv via the cache of the last W − 1 inputs
    hist = torch.cat([conv_cache, xBC_t.to(conv_cache.dtype)], dim=1)
    w = params["conv_w"]
    xBC = F.silu(torch.einsum("bwc,wc->bc", hist.float(), w.float()) + params["conv_b"]
                 )[:, None, :].to(x_t.dtype)
    conv_cache.copy_(hist[:, 1:, :])

    xs, Bmat, Cmat = xBC[..., :din], xBC[..., din:din + G * N], xBC[..., din + G * N:]
    xs = xs.reshape(Bsz, H, P)
    rep = H // G
    Bv = _rep(Bmat.reshape(Bsz, G, N), rep, 1)                     # (B, H, N)
    Cv = _rep(Cmat.reshape(Bsz, G, N), rep, 1)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])      # (B, H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A[None, :])                             # (B, H)
    upd = torch.einsum("bhp,bhn->bhpn", xs.float() * dt[..., None], Bv.float())
    state.copy_(state * decay[..., None, None] + upd)
    y = torch.einsum("bhn,bhpn->bhp", Cv.float(), state)
    y = y + xs.float() * params["D"][None, :, None]
    y = y.reshape(Bsz, 1, din).to(x_t.dtype)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm"])
    return y @ params["out_proj"], conv_cache, state


def _block(n: int, mesh, cut_here: bool) -> slice:
    """This rank's block of n elements of a dimension cut over 'model'
    (``cut_here``; else all of them)."""
    if not cut_here:
        return slice(None)
    k = n // mesh["model"]
    return slice(mesh.coords["model"] * k, (mesh.coords["model"] + 1) * k)


def mamba_decode_sharded(params, x_t: torch.Tensor, conv_cache: torch.Tensor, state: torch.Tensor,
                         cfg: ModelConfig, mesh, *, batch: int, conv_cut: int | None, state_cut: int | None):
    """``mamba_decode`` on this rank's blocks: x_t (B_loc, 1, d) its rows of
    the global batch ``batch``; ``params`` its blocks of in_proj (columns
    over 'model', d whole or over 'data'), conv_w (channels over 'model',
    the same as ``conv_cache``'s where both are cut) and out_proj (d_inner
    over 'model'), the rest whole. ``conv_cache`` is the rank's block of
    (B_loc, W − 1, conv_dim) cut over 'model' along dimension ``conv_cut``
    (0 its rows, every channel: a cut conv_w's (W, conv_dim/m) blocks are
    gathered over 'model', the one parameter block that moves; 2 its
    channels; None whole), ``state``
    of (B_loc, H, P, N) along ``state_cut`` (0 its rows, 1 its heads, 3 its
    N-block, or None); a cut along P raises. Both are updated in place; only (B, 1, ·)
    projections, conv outputs and y's partial sums or rows move
    → (B_loc, 1, d)."""
    if conv_cut not in (None, 0, 2) or state_cut not in (None, 0, 1, 3):
        raise ValueError(f"mamba_decode_sharded: conv cut along {conv_cut} and state along {state_cut} over "
                         f"'model' (no sharded body reads them)")
    mamba_decode_sharded.calls += 1
    bspec = _decode_bspec(mesh, batch)
    Bsz, d = x_t.shape[0], cfg.d_model
    din, H, P, N, G = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_ngroups
    conv_dim = din + 2 * G * N
    warm_host_math(x_t)
    zxbcdt, = col_proj(x_t, [params["in_proj"]], d, mesh, bspec)
    if zxbcdt.shape[-1] != 2 * din + 2 * G * N + H:
        zxbcdt = all_gather(zxbcdt, "model", mesh, dim=-1)
    z, xBC_t, dt_raw = _split(cfg, zxbcdt)                         # (B_loc, 1, ·)
    # the causal conv on the rank's block of the cache of the last W − 1 inputs
    rows, chans = _block(Bsz, mesh, conv_cut == 0), _block(conv_dim, mesh, conv_cut == 2)
    w = params["conv_w"]
    if conv_cut == 0 and w.shape[1] != conv_dim:      # the rank's rows need every channel's filter
        w = all_gather(w, "model", mesh, dim=1)
    if w.shape[1] == conv_dim:
        w = w[:, chans]
    hist = torch.cat([conv_cache, xBC_t[rows][..., chans].to(conv_cache.dtype)], dim=1)
    xBC = F.silu(torch.einsum("bwc,wc->bc", hist.float(), w.float()) + params["conv_b"][chans]
                 )[:, None, :].to(x_t.dtype)
    conv_cache.copy_(hist[:, 1:, :])
    if conv_cut is not None:
        xBC = all_gather(xBC, "model", mesh, dim=0 if conv_cut == 0 else 2)

    xs, Bmat, Cmat = xBC[..., :din], xBC[..., din:din + G * N], xBC[..., din + G * N:]
    xs = xs.reshape(Bsz, H, P)
    rep = H // G
    Bv = _rep(Bmat.reshape(Bsz, G, N), rep, 1)                     # (B, H, N)
    Cv = _rep(Cmat.reshape(Bsz, G, N), rep, 1)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])      # (B, H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A[None, :])                             # (B, H)
    # the rank's block of the state: its rows, heads or N-block
    b, h, n = _block(Bsz, mesh, state_cut == 0), _block(H, mesh, state_cut == 1), _block(N, mesh, state_cut == 3)
    xdt = xs.float() * dt[..., None]
    upd = torch.einsum("bhp,bhn->bhpn", xdt[b, h], Bv.float()[b, h, n])
    state.copy_(state * decay[b, h][..., None, None] + upd)
    y = torch.einsum("bhn,bhpn->bhp", Cv.float()[b, h, n], state)
    if state_cut == 3:
        y = all_reduce(y, "model", mesh)                           # y's partial sums over N
    elif state_cut is not None:
        y = all_gather(y, "model", mesh, dim=state_cut)
    y = y + xs.float() * params["D"][None, :, None]
    y = y.reshape(Bsz, 1, din).to(x_t.dtype)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm"])
    wo = params["out_proj"]                                        # (din_loc, d_loc)
    return row_proj(y[..., _block(din, mesh, wo.shape[0] != din)], wo, d, mesh, bspec, cut=wo.shape[0] != din)


mamba_decode_sharded.calls = 0   # Mamba-2 layers decoded on a rank's cache blocks, this process
