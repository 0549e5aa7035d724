"""Mixture-of-Experts layer (DeepSeek-V2/V3 style), the port of
``repro.models.moe`` on one device.

Shared expert(s) plus routed experts with top-k routing: ``softmax``
(DeepSeek-V2) or ``sigmoid`` with ``router_bias`` (DeepSeek-V3, gates
renormalised over the top k), the reference's 1e-9 floors, and the
lower expert first among equal scores, as ``jax.lax.top_k`` orders them.
Dispatch is the reference's GShard ``gather`` path: a K-step loop of
one-hot cumulative sums gives each (token, choice) its slot in its
expert, slots at or past the capacity C = max(8, ⌊T·K·cf/E⌋) go to a
drop bin, the tokens scatter into an (E·C + 1, d) buffer, the expert
FFNs run as batched products over (E, C, d), and the results gather
back weighted by their gates. The aux load-balance loss is
coef · E · Σ_e f_e · p_e. No kernel: the products are plain large
matrix products (the reference leaves them to XLA), and the rest is
stock PyTorch operations.

``MOE_IMPL`` (``set_moe_impl``) picks the dispatch as the reference's
does: ``gather`` (the default), ``a2a`` (expert parallelism with explicit
all-to-alls, ``_moe_a2a``) or ``auto`` (a2a where the mesh and the shapes
allow it, ``_a2a_applicable``). The a2a dispatch runs under a mesh
placed over a process group (``launch.mesh.make_mesh``), each rank on its
block of the tokens (``moe_a2a_specs``): rows over the batch axes, the
sequence over 'model'; experts over 'model' with their input dimension
over 'data' (1-D EP, gathered once a layer), or over 'model' × 'data'
when the experts divide it (2-D EP, no gather). A shapes-only mesh has no
process group, so a2a is not applicable under it (the dry run's ``meta``
programs).

The gather dispatch of a sharded batch (``moe_gather_sharded``), which the
reference leaves to XLA's SPMD partitioner, keeps the one-device
dispatch's global semantics: the capacity C = max(8, ⌊T·K·cf/E⌋) of the
global token count T, each (token, choice)'s slot counted in the global
token order (the rows pod-major, then the sequence; k-major, the counts
carried from k to k + 1) from every rank's expert ids gathered over the
mesh, and the aux loss's global means. Each token is routed by one rank:
the ranks that hold the same rows ('model', and any batch axis the rows
do not split over) share them out. A rank writes its kept tokens into
an (E, C, d) buffer of global slots; an all-to-all over the axes the
experts are cut over (``param_specs``: 'model' × 'data' with 2-D EP, else
'model') sends each owner its experts' slots, summed over the senders
(exact: a slot has one sender), the owner runs its resident experts,
and the outputs come back by the mirror all-to-all. ``moe_sharded`` is the
moe block of training and prefill on a rank's rows: the gather dispatch,
or the a2a on the rank's S/m block with y gathered over 'model' along S;
the shared experts through ``attention.mlp_sharded``. Under a placed
mesh ``moe_layer`` takes the a2a's layout for either dispatch. The
expert products stay stock batched products, as the reference's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from .._device import warm_host_math
from ..launch.mesh import all_gather, all_reduce, all_to_all, gather_dims, placed, spec_axes
from .attention import _batch_row_start, current_mesh, mlp_sharded
from .common import ModelConfig
from .layers import init_linear_, linear

__all__ = ["MoEParams", "init_moe_", "moe_layer", "set_moe_impl", "moe_a2a_specs", "moe_sharded",
           "moe_gather_sharded", "moe_a2a_sharded"]

# 'gather' — the GShard scatter/gather dispatch (the default);
# 'a2a'    — expert parallelism with explicit all-to-alls over 'model'
#            (and 'data' with 2-D EP);
# 'auto'   — a2a wherever the mesh and the shapes allow it.
MOE_IMPL = "gather"


def set_moe_impl(impl: str) -> None:
    global MOE_IMPL
    if impl not in ("gather", "a2a", "auto"):
        raise ValueError(f"set_moe_impl: {impl!r} is not 'gather', 'a2a' or 'auto'")
    MOE_IMPL = impl


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class MoEParams(nn.Module):
    """One layer's experts in the reference's layouts: router (d, E)
    float32; w_gate, w_up (E, d, f) and w_down (E, f, d); router_bias (E,)
    float32 with the sigmoid router; ``shared``, the shared experts as one
    MLP of width f · num_shared_experts, where the config has them.
    Indexed by name, as the reference's dict is."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        E, d, f, dt = cfg.num_experts, cfg.d_model, cfg.moe_d_ff, cfg.pdtype
        self.router = _param((d, E), torch.float32, device)
        self.w_gate = _param((E, d, f), dt, device)
        self.w_up = _param((E, d, f), dt, device)
        self.w_down = _param((E, f, d), dt, device)
        self.router_bias = _param(E, torch.float32, device) if cfg.router == "sigmoid" else None
        self.shared = None
        if cfg.num_shared_experts:
            fs = f * cfg.num_shared_experts
            self.shared = nn.ParameterDict({"w_gate": _param((d, fs), dt, device),
                                            "w_up": _param((d, fs), dt, device),
                                            "w_down": _param((fs, d), dt, device)})

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return getattr(self, name, None) is not None


@torch.no_grad()
def init_moe_(p: MoEParams, cfg: ModelConfig, generator: torch.Generator) -> None:
    """The reference's scheme: router and expert weights N(0, 1)/√fan_in
    (drawn in float32), router_bias zero."""
    d, f = cfg.d_model, cfg.moe_d_ff
    init_linear_(p.router, d, generator)
    init_linear_(p.w_gate, d, generator)
    init_linear_(p.w_up, d, generator)
    init_linear_(p.w_down, f, generator)
    if p.router_bias is not None:
        p.router_bias.zero_()
    if p.shared is not None:
        init_linear_(p.shared["w_gate"], d, generator)
        init_linear_(p.shared["w_up"], d, generator)
        init_linear_(p.shared["w_down"], p.shared["w_down"].shape[0], generator)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, the lower index first among equals
    (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, xt: torch.Tensor, cfg: ModelConfig, logits: torch.Tensor | None = None):
    """(T, d) tokens → gates (T, K), expert ids idx (T, K) and the
    routing probabilities probs (T, E), all float32 but idx. ``logits``
    (T, E) float32, where given, are the router's (computed where its
    weight is cut)."""
    K = cfg.top_k
    warm_host_math(xt)
    if logits is None:
        logits = torch.matmul(xt.float(), params["router"])
    if cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
        _, idx = _top_k(scores + params["router_bias"], K)
        gates = torch.gather(scores, -1, idx)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, idx = _top_k(probs, K)
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), idx, probs


def _positions_in_expert(idx: torch.Tensor, E: int) -> torch.Tensor:
    """(T, K) expert ids → (T, K) slots within each expert: choice k of
    token t comes after every choice < k of every token and after choice
    k of the tokens before t (the reference's K-step scan; one (T, E)
    one-hot at a time)."""
    counts = torch.zeros(E, dtype=torch.int64, device=idx.device)
    cols = []
    for k in range(idx.shape[1]):
        oh = F.one_hot(idx[:, k], E)                           # (T, E)
        pos = torch.cumsum(oh, dim=0) - oh + counts
        cols.append((pos * oh).sum(-1))
        counts = counts + oh.sum(0)
    return torch.stack(cols, dim=1)


def _a2a_applicable(cfg: ModelConfig, S: int, mesh=None) -> bool:
    """The reference's rule on ``mesh`` (by default the current mesh) and
    the global sequence length S."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return False
    m = mesh.get("model", 1)
    return m > 1 and S % m == 0 and cfg.num_experts % m == 0 and S >= m


def moe_layer(params, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) → (y (B, S, d), aux loss float32), dispatched by
    ``MOE_IMPL``. Under a placed mesh x is this rank's block (B_loc,
    S_loc, d) of ``moe_a2a_specs`` (its global S is S_loc times 'model'),
    the parameters its blocks, and the a2a dispatch runs where it applies,
    else the gather dispatch of the sharded batch; elsewhere the gather
    dispatch runs on the whole batch."""
    mesh = current_mesh()
    if placed(mesh):
        m = mesh.get("model", 1)
        if MOE_IMPL in ("a2a", "auto") and _a2a_applicable(cfg, x.shape[1] * m, mesh):
            return _moe_a2a(params, x, cfg)
        # the rows' whole sequence, as a sharded step holds it: the dispatch takes this rank's block back
        Bl, Sl, d = x.shape
        y, aux = moe_gather_sharded(params, all_gather(x, "model", mesh, dim=1), cfg, mesh, moe_a2a_specs(cfg, mesh),
                                    _batch_axes(mesh))
        r = mesh.coords.get("model", 0)
        return _shared(params, x.reshape(Bl * Sl, d), y[:, r * Sl:(r + 1) * Sl].reshape(Bl * Sl, d)).view(x.shape), aux
    return _moe_gather(params, x, cfg)


def moe_a2a_specs(cfg: ModelConfig, mesh) -> dict:
    """The reference's in_specs of ``_moe_a2a``'s body: x (B, S, d) with B
    over the batch axes and S over 'model'; the router (and its bias)
    whole; the experts (E, d, f) / (E, f, d) over 'model' × 'data'
    (model-major) when E divides it (2-D EP), else E over 'model' and d
    over 'data' where it divides (1-D EP, ZeRO'd). The shared experts run
    outside the body on every token with their whole weights."""
    m, dsz = mesh.get("model", 1), mesh.get("data", 1)
    bax = ("pod", "data") if mesh.get("pod", 1) > 1 else ("data",)
    if dsz > 1 and cfg.num_experts % (m * dsz) == 0:
        w = wd = (("model", "data"), None, None)
    else:
        zero_d = dsz > 1 and cfg.d_model % dsz == 0
        w = ("model", "data" if zero_d else None, None)
        wd = ("model", None, "data" if zero_d else None)
    specs = {"x": (bax, "model", None), "router": (None, None), "w_gate": w, "w_up": w, "w_down": wd}
    if cfg.router == "sigmoid":
        specs["router_bias"] = (None,)
    if cfg.num_shared_experts:
        specs["shared"] = {"w_gate": (None, None), "w_up": (None, None), "w_down": (None, None)}
    return specs


def _moe_a2a(params, x: torch.Tensor, cfg: ModelConfig):
    """Expert parallelism on this rank's blocks (``moe_a2a_specs``) under
    the current mesh: x (B_loc, S_loc, d) → (y (B_loc, S_loc, d), aux): the
    routed experts (``_a2a_routed``), then the shared experts on this
    rank's tokens with their whole weights."""
    Bl, Sl, d = x.shape
    y, aux = _a2a_routed(params, x, cfg, current_mesh())
    return _shared(params, x.reshape(Bl * Sl, d), y.reshape(Bl * Sl, d)).view(Bl, Sl, d), aux


def _a2a_routed(params, x: torch.Tensor, cfg: ModelConfig, mesh):
    """The routed experts of the a2a dispatch on this rank's tokens
    x (B_loc, S_loc, d) → (y (B_loc, S_loc, d), aux). The rank routes its
    T_loc tokens into an (E, C_loc, d) buffer, C_loc = max(4, ⌊T_loc·K·cf/E⌋);
    an all-to-all over 'model' (then over 'data' with 2-D EP) swaps
    expert-major for sender-major, the local experts run on their resident
    weights (gathered over 'data' when ZeRO'd), and the reverse
    all-to-alls bring the outputs back. aux comes from the mean of the
    global statistics, the same on every rank: a global loss is the sum of
    the ranks' losses with aux counted once (aux / world on each rank).
    Gradients flow through both all-to-alls and the weight gathers."""
    m, dsz = mesh.get("model", 1), mesh.get("data", 1)
    E, K = cfg.num_experts, cfg.top_k
    ep2d = dsz > 1 and E % (m * dsz) == 0
    E_loc = E // (m * dsz) if ep2d else E // m
    Bl, Sl, d = x.shape
    T = Bl * Sl
    xt = x.reshape(T, d)
    gates, idx, probs = _route(params, xt, cfg)
    # aux from the global statistics: a mean over every rank of the mesh
    world = math.prod(mesh.values())
    f_e = all_reduce(F.one_hot(idx[:, 0], E).float().mean(dim=0), None, mesh) / world
    p_e = all_reduce(probs.mean(dim=0), None, mesh) / world
    aux = cfg.aux_loss_coef * E * torch.sum(f_e * p_e)

    C = max(4, int(T * K * cfg.capacity_factor / E))
    pos = _positions_in_expert(idx, E)
    keep = pos < C
    slot = torch.where(keep, idx * C + pos, E * C).reshape(-1)  # E·C: the drop bin
    buf = x.new_zeros((E * C + 1, d))
    buf[slot] = xt.repeat_interleave(K, dim=0)                  # kept slots are unique
    buf = buf[: E * C]
    # dispatch: expert-major → (sender, local expert)-major
    if ep2d:
        b = all_to_all(buf.reshape(m, dsz, E_loc, C, d), "model", mesh)   # (m_src, dsz, E_loc, C, d)
        b = all_to_all(b.transpose(0, 1), "data", mesh)                  # (dsz_src, m_src, E_loc, C, d)
        b = b.permute(2, 1, 0, 3, 4).reshape(E_loc, m * dsz * C, d)
    else:
        b = all_to_all(buf.reshape(m, E_loc, C, d), "model", mesh)       # (m_src, E_loc, C, d)
        b = b.transpose(0, 1).reshape(E_loc, m * C, d)
    out = _experts(params, b, d, mesh)
    # the return trip, the dispatch's mirror
    if ep2d:
        o = all_to_all(out.reshape(E_loc, m, dsz, C, d).permute(2, 1, 0, 3, 4), "data", mesh)
        o = all_to_all(o.transpose(0, 1), "model", mesh).reshape(E * C, d)
    else:
        o = all_to_all(out.reshape(E_loc, m, C, d).transpose(0, 1), "model", mesh).reshape(E * C, d)
    flat = torch.cat([o, o.new_zeros((1, d))])
    y = (flat[slot].view(T, K, d) * (gates * keep).to(x.dtype)[..., None]).sum(dim=1)
    return y.view(Bl, Sl, d), aux


def _experts(params, b: torch.Tensor, d: int, mesh) -> torch.Tensor:
    """The rank's resident experts on their (E_loc, n, d) buffer: the
    SwiGLU FFN as batched products, weights ZeRO'd along d gathered over
    'data' once a layer."""
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if wg.shape[1] != d:
        wg = all_gather(wg, "data", mesh, dim=1)
        wu = all_gather(wu, "data", mesh, dim=1)
    if wd.shape[2] != d:
        wd = all_gather(wd, "data", mesh, dim=2)
    warm_host_math(b)
    h = F.silu(torch.bmm(b, wg)) * torch.bmm(b, wu)
    return torch.bmm(h, wd)


def _batch_axes(mesh) -> tuple:
    """The axes a sharded step's batch rows split over, pod-major
    (``runtime.sharding.batch_axes``)."""
    return tuple(a for a in ("pod", "data") if mesh.get(a, 1) > 1)


def _gather_dispatch(params, xt: torch.Tensor, tok: torch.Tensor, live, T: int, cfg: ModelConfig, mesh,
                     specs: dict, logits: torch.Tensor | None = None):
    """The gather dispatch's routed experts on this rank's share of the
    global batch: xt (n, d) its tokens, ``tok`` (n,) their indices in the
    global token order (−1 where ``live``, a boolean (n,) or None, marks a
    padding token), T the global token count, every token routed by one
    rank (by ``logits`` (n, E) where given); the experts cut as ``specs``
    gives them. → (y (n, d), aux)."""
    n, d = xt.shape
    E, K = cfg.num_experts, cfg.top_k
    gates, idx, probs = _route(params, xt, cfg, logits)
    top1 = F.one_hot(idx[:, 0], E).float()
    if live is not None:
        top1, probs = top1 * live[:, None], probs * live[:, None]
    f_e = all_reduce(top1.sum(dim=0), None, mesh) / T
    p_e = all_reduce(probs.sum(dim=0), None, mesh) / T
    aux = cfg.aux_loss_coef * E * torch.sum(f_e * p_e)
    # every (token, choice)'s slot in the global order, from every rank's ids
    C = max(8, int(T * K * cfg.capacity_factor / E))
    with torch.no_grad():
        every_tok, every_idx = all_gather(tok, None, mesh, 0), all_gather(idx, None, mesh, 0)
        # row T takes the padding tokens' choices and is dropped: shapes only, so it runs on meta too
        glob = torch.zeros((T + 1, K), dtype=idx.dtype, device=idx.device)
        glob[torch.where(every_tok >= 0, every_tok, T)] = every_idx
        pos_all = _positions_in_expert(glob[:T], E)
        pos = pos_all[tok.clamp(min=0)]
        if pos_all.device.type != "meta":
            moe_gather_sharded.dropped += int((pos_all >= C).sum())
    keep = pos < C if live is None else (pos < C) & live[:, None]
    slot = torch.where(keep, idx * C + pos, E * C).reshape(-1)  # E·C: the drop bin
    buf = xt.new_zeros((E * C + 1, d))
    buf[slot] = xt.repeat_interleave(K, dim=0)                  # kept slots are unique
    buf = buf[: E * C].view(E, C, d)
    # each owner's experts' slots, summed over the senders (one sender a slot)
    eax = tuple(a for a in spec_axes(specs["w_gate"][0]) if mesh.get(a, 1) > 1)
    for ax in eax:
        k = mesh[ax]
        buf = all_to_all(buf.reshape(k, buf.shape[0] // k, C, d), ax, mesh).sum(dim=0)
    out = _experts(params, buf, d, mesh)
    for ax in reversed(eax):       # every owner's outputs back to every sender
        k = mesh[ax]
        out = all_to_all(out.expand(k, *out.shape), ax, mesh).reshape(k * out.shape[0], C, d)
    flat = torch.cat([out.reshape(E * C, d), out.new_zeros((1, d))])
    y = (flat[slot].view(n, K, d) * (gates * keep).to(xt.dtype)[..., None]).sum(dim=1)
    return y, aux


def moe_gather_sharded(params, x: torch.Tensor, cfg: ModelConfig, mesh, specs: dict, bspec,
                       logits: torch.Tensor | None = None):
    """The routed experts of the gather dispatch on a rank's rows x
    (B_loc, S, d) of a global batch split over the axes ``bspec`` (a tuple,
    or None), the same rows on every rank of the mesh's other axes, which
    share their tokens out: each takes an S/n block of every row where n
    divides S, else a block of the rows' tokens in order (the last padded).
    ``params`` holds the router whole (or ``logits`` (B_loc, S, E), float32,
    are the router's, where its weight is cut) and the experts' blocks
    under ``specs`` → (y (B_loc, S, d), aux), y the same on the ranks that share
    the rows. ``.calls`` counts its calls (``moe_layer``'s under a placed
    mesh too), ``.dropped`` the (token, choice) pairs past the capacity, of
    the global batch, that they dropped."""
    moe_gather_sharded.calls += 1
    Bl, S, d = x.shape
    bax = tuple(bspec or ())
    rep = tuple(a for a in mesh if mesh[a] > 1 and a not in bax)
    n = math.prod(mesh[a] for a in rep)
    c = 0
    for a in rep:
        c = c * mesh[a] + mesh.coords[a]
    row0 = _batch_row_start(mesh, bax, Bl)
    T = Bl * math.prod(mesh[a] for a in bax) * S
    dev = x.device
    if S % n == 0:
        Sn = S // n
        xt = x[:, c * Sn:(c + 1) * Sn].reshape(Bl * Sn, d)
        tok = ((row0 + torch.arange(Bl, device=dev))[:, None] * S + c * Sn
               + torch.arange(Sn, device=dev)).reshape(-1)
        lt = None if logits is None else logits[:, c * Sn:(c + 1) * Sn].reshape(Bl * Sn, -1)
        y, aux = _gather_dispatch(params, xt, tok, None, T, cfg, mesh, specs, lt)
        return gather_dims(y.view(Bl, Sn, d), (None, rep or None, None), mesh), aux
    Tr = Bl * S
    Tn = -(-Tr // n)
    xt = F.pad(x.reshape(Tr, d), (0, 0, 0, n * Tn - Tr))[c * Tn:(c + 1) * Tn]
    loc = c * Tn + torch.arange(Tn, device=dev)
    live = loc < Tr
    lt = None if logits is None else F.pad(logits.reshape(Tr, -1), (0, 0, 0, n * Tn - Tr))[c * Tn:(c + 1) * Tn]
    y, aux = _gather_dispatch(params, xt, torch.where(live, row0 * S + loc, -1), live, T, cfg, mesh, specs, lt)
    return gather_dims(y, (rep or None, None), mesh)[:Tr].view(Bl, S, d), aux


def moe_a2a_sharded(params, x: torch.Tensor, cfg: ModelConfig, mesh):
    """The routed experts of the a2a dispatch on a rank's rows x (B_loc, S,
    d), the same on every rank of 'model': the rank's S/m block through
    ``_a2a_routed`` (the reference's x spec: rows over the batch axes, S
    over 'model'), y gathered over 'model' along S (its gradient summed
    over 'model' and cut back) → (y (B_loc, S, d), aux)."""
    moe_a2a_sharded.calls += 1
    S, m = x.shape[1], mesh["model"]
    r = mesh.coords["model"]
    y, aux = _a2a_routed(params, x[:, r * (S // m):(r + 1) * (S // m)], cfg, mesh)
    return all_gather(y, "model", mesh, dim=1), aux


def moe_sharded(params, x: torch.Tensor, cfg: ModelConfig, mesh, specs: dict):
    """The moe block's second half on a rank's rows x (B_loc, S, d) of a
    sharded step (training, prefill), on its blocks cut by ``specs``
    (``param_specs``): the router gathered whole, the routed experts by
    the a2a dispatch where ``MOE_IMPL`` asks for it and it applies, else by
    the gather dispatch; the shared experts through ``mlp_sharded``
    → (y (B_loc, S, d), aux), the same on every rank of 'model'."""
    routed = {"router": gather_dims(params["router"], specs["router"], mesh)}
    for w in ("w_gate", "w_up", "w_down", "router_bias"):
        if w in params:
            routed[w] = params[w]
    if MOE_IMPL in ("a2a", "auto") and _a2a_applicable(cfg, x.shape[1], mesh):
        y, aux = moe_a2a_sharded(routed, x, cfg, mesh)
    else:
        y, aux = moe_gather_sharded(routed, x, cfg, mesh, specs, _batch_axes(mesh))
    if "shared" in params:
        sh = {k[len("shared."):]: v for k, v in specs.items() if k.startswith("shared.")}
        y = y + mlp_sharded(params["shared"], x, cfg, mesh, sh, kind="swiglu")
    return y, aux


moe_gather_sharded.calls = 0     # calls of the gather dispatch of a sharded batch (remat's recompute too)
moe_gather_sharded.dropped = 0   # (token, choice) pairs of the global batch past the capacity, summed over calls
moe_a2a_sharded.calls = 0        # calls of the a2a dispatch on a sharded step's rows


def _shared(params, xt: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y plus the shared experts' output on the tokens xt, where the layer has them."""
    if "shared" not in params:
        return y
    sh = params["shared"]
    hs = F.silu(linear(xt, sh["w_gate"])) * linear(xt, sh["w_up"])
    return y + linear(hs, sh["w_down"])


def _moe_gather(params, x: torch.Tensor, cfg: ModelConfig):
    """The reference's ``_moe_gather`` and its shared experts (in
    ``moe.combine``). While tracing is on, the (token, choice) pairs it
    routes and those it drops count on the device (``moe.routed``,
    ``moe.dropped``)."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.top_k
    C = max(8, int(T * K * cfg.capacity_factor / E))
    xt = x.reshape(T, d)
    with tracing.span("moe.route"):
        gates, idx, probs = _route(params, xt, cfg)
        f_e = F.one_hot(idx[:, 0], E).float().mean(dim=0)
        aux = cfg.aux_loss_coef * E * torch.sum(f_e * probs.mean(dim=0))
    with tracing.span("moe.dispatch"):
        pos = _positions_in_expert(idx, E)
        keep = pos < C
        if tracing.is_on():
            tracing.count("moe.routed", T * K)
            tracing.count("moe.dropped", keep.numel() - keep.sum())
        slot = torch.where(keep, idx * C + pos, E * C).reshape(-1)  # E·C: the drop bin
        buf = x.new_zeros((E * C + 1, d))
        buf[slot] = xt.repeat_interleave(K, dim=0)                  # kept slots are unique
        buf = buf[: E * C].view(E, C, d)
    with tracing.span("moe.experts"):
        h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(buf, params["w_up"])
        out = torch.bmm(h, params["w_down"]).reshape(E * C, d)
    with tracing.span("moe.combine"):
        flat = torch.cat([out, out.new_zeros((1, d))])
        y = (flat[slot].view(T, K, d) * (gates * keep).to(x.dtype)[..., None]).sum(dim=1)
        return _shared(params, xt, y).view(B, S, d), aux
