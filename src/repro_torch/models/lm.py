"""The language model of the dense family as an ``nn.Module``.

``LM(cfg, device=None)`` allocates the parameters on the CUDA card (or
on ``device``) uninitialised; ``init(generator)`` fills them from an
explicit ``torch.Generator``, with the reference's scheme (normal
draws scaled 1/√fan_in, embeddings 0.02, norms zero). Parameters keep
the reference's layouts (wq (d, H, D), wo (H, D, d), MLP (d, f)/(f, d))
one block a layer, so ``models.interop.params_from_reference`` carries
a reference tree across by name. Nothing here builds an autograd graph:
training is a later slice (ROADMAP.md).

Other families raise ``NotImplementedError`` (ROADMAP.md, queue A12).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .._device import resolve_device
from .attention import attention, init_attention, init_attention_
from .common import ModelConfig, layer_flags
from .layers import embed, init_embedding_, init_linear_, mlp, rms_norm, softcap

__all__ = ["LM", "Block"]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def _init_mlp(cfg: ModelConfig, device) -> nn.ParameterDict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype
    names = ("w_gate", "w_up") if cfg.mlp in ("swiglu", "geglu") else ("w_up",)
    p = {n: _param((d, f), dt, device) for n in names}
    p["w_down"] = _param((f, d), dt, device)
    return nn.ParameterDict(p)


class Block(nn.Module):
    """Pre-norm attention block: ln1, attn, ln2, mlp."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = _param(cfg.d_model, torch.float32, device)
        self.attn = init_attention(cfg, device)
        self.ln2 = _param(cfg.d_model, torch.float32, device)
        self.mlp = _init_mlp(cfg, device)

    @torch.no_grad()
    def init(self, cfg: ModelConfig, generator: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        init_attention_(self.attn, cfg, generator)
        for w in self.mlp.values():
            init_linear_(w, w.shape[0], generator)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, is_global: bool) -> torch.Tensor:
        x = x + attention(self.attn, rms_norm(x, self.ln1), cfg, is_global=is_global)
        return x + mlp(self.mlp, rms_norm(x, self.ln2), cfg.mlp)


class LM(nn.Module):
    """One dense architecture: embedding, ``num_layers`` blocks, final
    norm, tied or untied head."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet; only dense models run "
                "in repro_torch so far (ROADMAP.md, queue A12)")
        dev = resolve_device(device)
        self.cfg = cfg
        self.flags = layer_flags(cfg)
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = _param((V, d), cfg.pdtype, dev)
        self.final_norm = _param(d, torch.float32, dev)
        if not cfg.tie_embeddings:
            self.unembed = _param((V, d), cfg.pdtype, dev)
        self.blocks = nn.ModuleList(Block(cfg, dev) for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ---------------- init ----------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Fill every parameter from ``generator`` (on this model's
        device), in a fixed order: the same seed gives the same model."""
        init_embedding_(self.embed, generator)
        self.final_norm.zero_()
        if not self.cfg.tie_embeddings:
            init_embedding_(self.unembed, generator)
        for blk in self.blocks:
            blk.init(self.cfg, generator)
        return self

    # ---------------- embedding / head ----------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = embed(tokens, self.embed).to(cfg.cdtype)
        # the scale is rounded to the compute type first (√3584 → 59.75 in bf16)
        return x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype, device=x.device)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.final_norm)
        table = self.embed if cfg.tie_embeddings else self.unembed
        logits = torch.matmul(x, table.t()).to(torch.float32)   # product in the compute type
        return softcap(logits, cfg.final_logit_softcap)

    # ---------------- forward (prefill) ----------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *, last_only: bool = False):
        """tokens (B, S) → (logits, aux_loss); ``last_only`` (serving
        prefill) emits the final position's logits only, so the (B, S, V)
        tensor never exists."""
        x = self._backbone(tokens)
        if last_only:
            x = x[:, -1:]
        return self._logits(x), torch.zeros((), dtype=torch.float32, device=x.device)

    def _backbone(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) → final hidden states (B, S, d), before the final
        norm. Layers run in order with their per-layer global flag: the
        reference's period-grouped L…G scan and its flag scan both reduce
        to this for the dense family."""
        x = self._embed(tokens)
        for blk, is_global in zip(self.blocks, self.flags["is_global"]):
            x = blk(x, self.cfg, bool(is_global))
        return x
