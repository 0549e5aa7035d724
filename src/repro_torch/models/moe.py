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

Left for a later slice (ROADMAP.md, queue A12.5): the reference's
``a2a`` expert parallelism and its ``set_moe_impl`` knob, which need
several cards.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .._device import warm_host_math
from .common import ModelConfig
from .layers import init_linear_, linear

__all__ = ["MoEParams", "init_moe_", "moe_layer"]


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


def _route(params, xt: torch.Tensor, cfg: ModelConfig):
    """(T, d) tokens → gates (T, K), expert ids idx (T, K) and the
    routing probabilities probs (T, E), all float32 but idx."""
    K = cfg.top_k
    warm_host_math(xt)
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


def moe_layer(params, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) → (y (B, S, d), aux loss float32): the reference's
    ``_moe_gather`` and its shared experts."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.top_k
    C = max(8, int(T * K * cfg.capacity_factor / E))
    xt = x.reshape(T, d)
    gates, idx, probs = _route(params, xt, cfg)
    f_e = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = cfg.aux_loss_coef * E * torch.sum(f_e * probs.mean(dim=0))

    pos = _positions_in_expert(idx, E)
    keep = pos < C
    slot = torch.where(keep, idx * C + pos, E * C).reshape(-1)  # E·C: the drop bin
    buf = x.new_zeros((E * C + 1, d))
    buf[slot] = xt.repeat_interleave(K, dim=0)                  # kept slots are unique
    buf = buf[: E * C].view(E, C, d)
    h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(buf, params["w_up"])
    out = torch.bmm(h, params["w_down"]).reshape(E * C, d)
    flat = torch.cat([out, out.new_zeros((1, d))])
    y = (flat[slot].view(T, K, d) * (gates * keep).to(x.dtype)[..., None]).sum(dim=1)
    if "shared" in params:
        sh = params["shared"]
        hs = F.silu(linear(xt, sh["w_gate"])) * linear(xt, sh["w_up"])
        y = y + linear(hs, sh["w_down"])
    return y.view(B, S, d), aux
