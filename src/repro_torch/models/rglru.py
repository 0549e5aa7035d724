"""RG-LRU recurrent block (RecurrentGemma / Griffin), the port of
``repro.models.rglru``.

The gated linear recurrence  h_t = a_t·h_{t−1} + √(1−a_t²)·(i_t⊙x_t)
with a_t = exp(−c·softplus(Λ)·r_t) is elementwise over the width. The
reference runs it as ``jax.lax.associative_scan`` over S; here the same
combine, (a1·a2, b1·a2 + b2), runs as a log-depth doubling scan over S
(⌈log2 S⌉ rounds of a few whole-tensor operations, no loop over tokens).
Gates and state are float32, products in the compute type, as in the
reference. Decode is one fused step against an (h, conv) cache that it
updates in place.

``rglru_sharded`` runs the block on a rank's rows and its blocks under a
mesh placed over a process group (training and prefill), cut by
``runtime.sharding.param_specs``: the width over 'model' (w_x, w_gate,
conv_w, w_r and w_i by their columns, out by its rows), d over 'data'
(gathered whole at use). The recurrence is elementwise over the width,
so each rank convolves, gates and scans its own channels; only the
input of w_r and w_i, the whole xw, is gathered over 'model' (its
gradient reduce-scattered back), and the row-parallel output is summed
over 'model'.

``rglru_decode_sharded`` is the one-step decode so, on a rank's rows
under a placed mesh (``models.decode``): the rank's width block of the
``h`` and ``conv`` caches, where the rules cut them, with the same
columns of the gates' weights; only the rank's (B, 1, w/m) conv output,
gathered for w_r and w_i, and the row-parallel output's float32 partial
sums move. Where the rules cut the caches along their rows instead (a
batch wider than the width), the rank updates its rows of every channel
and gathers the one-token activations between the two cuts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .._device import warm_host_math
from ..launch.mesh import all_gather, gather_dims
from .attention import _decode_bspec, col_proj, row_proj
from .common import ModelConfig
from .layers import init_linear_, row_parallel

__all__ = ["init_rglru", "init_rglru_", "rglru_forward", "rglru_decode", "init_rglru_state",
           "linear_scan", "rglru_sharded", "rglru_decode_sharded"]

_C = 8.0  # Griffin's fixed recurrence sharpness


def init_rglru(cfg: ModelConfig, device) -> nn.ParameterDict:
    """Uninitialised parameters (``init_rglru_`` fills them), in the
    reference's layouts: w_x, w_gate (d, w); conv_w (4, w); conv_b (w,)
    float32; w_r, w_i (w, w); lam (w,) float32; out (w, d)."""
    d, w, dt = cfg.d_model, cfg.lru_width_, cfg.pdtype
    shapes = {"w_x": ((d, w), dt), "w_gate": ((d, w), dt), "conv_w": ((4, w), dt),
              "conv_b": ((w,), torch.float32), "w_r": ((w, w), dt), "w_i": ((w, w), dt),
              "lam": ((w,), torch.float32), "out": ((w, d), dt)}
    return nn.ParameterDict({
        n: nn.Parameter(torch.empty(s, dtype=t, device=device), requires_grad=False)
        for n, (s, t) in shapes.items()})


@torch.no_grad()
def init_rglru_(p: nn.ParameterDict, cfg: ModelConfig, generator: torch.Generator) -> None:
    d, w = cfg.d_model, cfg.lru_width_
    init_linear_(p["w_x"], d, generator)
    init_linear_(p["w_gate"], d, generator)
    init_linear_(p["conv_w"], 1, generator, scale=0.02)
    p["conv_b"].zero_()
    init_linear_(p["w_r"], w, generator)
    init_linear_(p["w_i"], w, generator)
    p["lam"].copy_(torch.linspace(0.7, 2.5, w, dtype=torch.float32))
    init_linear_(p["out"], w, generator)


def _conv(x, w, b):
    """Depthwise causal conv over the sequence, rounded to x's type once:
    the reference's taps and bias are x's type, and XLA computes the
    chain in float32 under ``jit`` (it keeps the excess precision of a
    fused chain), where rounding after each tap would lose a few bits."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x.float(), (0, 0, W - 1, 0))
    w = w.to(x.dtype).float()
    out = sum(pad[:, i : i + S, :] * w[i][None, None, :] for i in range(W))
    return (out + b[None, None, :].to(x.dtype).float()).to(x.dtype)


def _gates(params, xw):
    warm_host_math(xw)
    return _gated(xw @ params["w_r"], xw @ params["w_i"], params["lam"], xw)


def _gated(r, i, lam, xw):
    """(a, gated) of channels whose gate pre-activations are r and i, decay
    parameters lam and conv outputs xw."""
    r = torch.sigmoid(r.float())
    i = torch.sigmoid(i.float())
    log_a = -_C * F.softplus(lam)[None, None, :] * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-8))
    gated = beta * i * xw.float()
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t−1} + b_t over dim 1 from h_{−1} = 0, by doubling:
    after the round of stride d every element holds the combine of the
    2d elements ending at it, (a1·a2, b1·a2 + b2) with 1 the earlier."""
    S, d = a.shape[1], 1
    while d < S:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], b_prev * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a_prev * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_forward(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d) via the scan over S."""
    xw = _conv(x @ params["w_x"], params["conv_w"], params["conv_b"])
    a, gated = _gates(params, xw)                    # (B, S, w) float32
    h = linear_scan(a, gated)
    gate = F.gelu((x @ params["w_gate"]).float(), approximate="tanh")
    y = (h * gate).to(x.dtype)
    return y @ params["out"]


def rglru_sharded(params, x: torch.Tensor, cfg: ModelConfig, mesh, specs: dict) -> torch.Tensor:
    """``rglru_forward`` of a rank's rows x (B_loc, S, d) on its blocks, cut
    by ``specs`` (name → spec): the rank's w/m channels convolved, gated and
    scanned, from the whole xw gathered over 'model' for w_r and w_i; the
    row-parallel output summed over 'model' → (B_loc, S, d), the same on
    every rank of 'model'. A width the rules leave whole (it does not
    divide 'model') runs whole on every rank."""
    rglru_sharded.calls += 1
    w = {n: gather_dims(params[n], specs[n], mesh, axes=("data",))
         for n in ("w_x", "w_gate", "conv_w", "w_r", "w_i", "out")}
    cols = w["w_x"].shape[1]
    if cols == cfg.lru_width_:
        return rglru_forward({n: params[n] for n in ("conv_b", "lam")} | w, x, cfg)
    c = slice(mesh.coords["model"] * cols, (mesh.coords["model"] + 1) * cols)
    xw_loc = _conv(x @ w["w_x"], w["conv_w"], params["conv_b"][c])
    warm_host_math(xw_loc)
    xw = all_gather(xw_loc, "model", mesh, dim=2)
    a, gated = _gated(xw @ w["w_r"], xw @ w["w_i"], params["lam"][c], xw_loc)
    h = linear_scan(a, gated)
    gate = F.gelu((x @ w["w_gate"]).float(), approximate="tanh")
    return row_parallel((h * gate).to(x.dtype), w["out"], mesh)


rglru_sharded.calls = 0   # calls of the sharded RG-LRU (remat's recompute too), this process


def init_rglru_state(cfg: ModelConfig, batch: int, layers: int, device=None) -> dict:
    w = cfg.lru_width_
    return {
        "h": torch.zeros((layers, batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((layers, batch, 3, w), dtype=cfg.cdtype, device=device),
    }


def rglru_decode(params, x_t: torch.Tensor, h: torch.Tensor, conv_cache: torch.Tensor,
                 cfg: ModelConfig):
    """One-step recurrence. x_t (B, 1, d); h (B, w); conv_cache (B, 3, w).
    Returns (y (B, 1, d), h, conv_cache), the caches updated in place."""
    xw_t = x_t @ params["w_x"]                        # (B, 1, w)
    hist = torch.cat([conv_cache, xw_t.to(conv_cache.dtype)], dim=1)
    w = params["conv_w"]
    xw = (torch.einsum("bwc,wc->bc", hist.float(), w.float()) + params["conv_b"]
          )[:, None, :].to(x_t.dtype)
    conv_cache.copy_(hist[:, 1:, :])
    a, gated = _gates(params, xw)                     # (B, 1, w)
    h.copy_(a[:, 0] * h + gated[:, 0])
    gate = F.gelu((x_t @ params["w_gate"]).float(), approximate="tanh")
    y = (h[:, None, :] * gate).to(x_t.dtype)
    return y @ params["out"], h, conv_cache


def rglru_decode_sharded(params, x_t: torch.Tensor, h: torch.Tensor, conv_cache: torch.Tensor, cfg: ModelConfig,
                         mesh, *, batch: int, rows: bool = False):
    """``rglru_decode`` channel-parallel on this rank's blocks: x_t
    (B_loc, 1, d) its rows of the global batch ``batch``; ``params`` its
    w_loc columns of w_x, w_gate, conv_w, w_r and w_i and rows of out (d
    whole, or cut over 'data': weight-stationary, ``attention.col_proj``),
    conv_b and lam whole; h (B_loc, w_loc) and conv_cache (B_loc, 3, w_loc)
    the same channels (w_loc = w where nothing is cut), or with ``rows``
    the rank's B_loc/m rows of them over 'model', every channel. The
    recurrence is elementwise over the width: the rank convolves, gates
    and updates its channels in place, from the whole conv output
    gathered over 'model' for w_r and w_i, and the output's row-parallel
    partial sums are summed over 'model' → (B_loc, 1, d).

    With ``rows`` the rank convolves and updates its rows of every
    channel: the one-token input, gates and state are regathered between
    its rows and its channels, and the conv filter's (4, w_loc) blocks are
    gathered over 'model', the one parameter block that moves."""
    rglru_decode_sharded.calls += 1
    bspec = _decode_bspec(mesh, batch)
    d, w, wl = cfg.d_model, cfg.lru_width_, params["w_x"].shape[-1]
    c0 = mesh.coords["model"] * wl if wl != w else 0
    c = slice(c0, c0 + wl)

    def widen(t):                                         # the rank's channels → every channel
        return t if wl == w else all_gather(t, "model", mesh, dim=2)

    xw_t, g = col_proj(x_t, [params["w_x"], params["w_gate"]], d, mesh, bspec)      # (B_loc, 1, w_loc)
    own = slice(None)
    conv_w, conv_b = params["conv_w"], params["conv_b"][c]
    if rows:
        n = h.shape[0]
        own = slice(mesh.coords["model"] * n, (mesh.coords["model"] + 1) * n)
        xw_t, conv_b = widen(xw_t)[own], params["conv_b"]
        conv_w = conv_w if wl == w else all_gather(conv_w, "model", mesh, dim=1)
    hist = torch.cat([conv_cache, xw_t.to(conv_cache.dtype)], dim=1)
    xw = (torch.einsum("bwc,wc->bc", hist.float(), conv_w.float()) + conv_b)[:, None, :].to(x_t.dtype)
    conv_cache.copy_(hist[:, 1:, :])
    warm_host_math(xw)
    if rows:
        xw_all = all_gather(xw, "model", mesh, dim=0)
        xw = xw_all[..., c]
    else:
        xw_all = widen(xw)
    a, gated = _gated(xw_all @ params["w_r"], xw_all @ params["w_i"], params["lam"][c], xw)
    if rows:
        a, gated = widen(a)[own], widen(gated)[own]
    h.copy_(a[:, 0] * h + gated[:, 0])
    hc = all_gather(h, "model", mesh, dim=0)[:, c] if rows else h
    gate = F.gelu(g.float(), approximate="tanh")
    y = (hc[:, None, :] * gate).to(x_t.dtype)
    return row_proj(y, params["out"], d, mesh, bspec, cut=wl != w)


rglru_decode_sharded.calls = 0   # recurrent layers decoded channel-parallel, this process
