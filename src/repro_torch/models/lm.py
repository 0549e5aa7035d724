"""The language model of the dense, vlm, moe, ssm, hybrid and encdec
families as an ``nn.Module`` (the port of ``repro.models.lm``).

``LM(cfg, device=None)`` allocates the parameters on the CUDA card (or
on ``device``) uninitialised; ``init(generator)`` fills them from an
explicit ``torch.Generator``, with the reference's scheme (normal
draws scaled 1/√fan_in, embeddings and conv taps 0.02, norms and tanh
gates zero). Parameters keep the reference's layouts one module a layer;
where the reference stacks a family's blocks over periods the port
nests them the same way, so ``self_blocks.3.1`` is the reference's
``self_blocks[3, 1]`` and ``models.interop.params_from_reference``
carries a reference tree across by name:

  dense   ``blocks.i``
  vlm     ``self_blocks.p.j`` (k − 1 a period), ``cross_blocks.p`` (tanh-gated)
  moe     ``dense_blocks.i`` (the first ``first_k_dense`` layers: MLA and a
          dense MLP), ``moe_blocks.i`` (MLA and routed experts)
  ssm     ``blocks.i`` (norm ``ln``, Mamba-2 mixer ``mix``)
  hybrid  ``rec_blocks.p.j`` (two RG-LRU blocks a period), ``attn_blocks.p``
          (a local attention block), ``extra_rec.i`` (the layers past the
          last whole period)
  encdec  ``enc_blocks.i``, ``enc_norm``, ``dec_self.i``, ``dec_cross.i``

``forward`` returns the moe family's summed aux load-balance loss beside
the logits, and zero for the other families, as the reference does.
Nothing here builds an autograd graph: training is a later slice
(ROADMAP.md).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .._device import resolve_device
from .attention import attention, init_attention, init_attention_
from .common import ModelConfig, layer_flags
from .layers import embed, init_embedding_, init_linear_, mlp, rms_norm, softcap
from .mla import init_mla, init_mla_, mla_attention
from .moe import MoEParams, init_moe_, moe_layer
from .rglru import init_rglru, init_rglru_, rglru_forward
from .ssm import init_mamba, init_mamba_, mamba_forward

__all__ = ["LM", "Block", "MLABlock", "MambaBlock", "RGLRUBlock"]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def _init_mlp(cfg: ModelConfig, device) -> nn.ParameterDict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype
    names = ("w_gate", "w_up") if cfg.mlp in ("swiglu", "geglu") else ("w_up",)
    p = {n: _param((d, f), dt, device) for n in names}
    p["w_down"] = _param((f, d), dt, device)
    return nn.ParameterDict(p)


@torch.no_grad()
def _init_mlp_(p: nn.ParameterDict, generator: torch.Generator) -> None:
    for w in p.values():
        init_linear_(w, w.shape[0], generator)


class Block(nn.Module):
    """Pre-norm attention block: ln1, attn, ln2, mlp. A cross block
    (``cross``) also has the mllama-style tanh gate ``xgate`` (a float32
    scalar) on its attention output."""

    def __init__(self, cfg: ModelConfig, device, cross: bool = False):
        super().__init__()
        self.ln1 = _param(cfg.d_model, torch.float32, device)
        self.attn = init_attention(cfg, device)
        self.ln2 = _param(cfg.d_model, torch.float32, device)
        self.mlp = _init_mlp(cfg, device)
        self.xgate = _param((), torch.float32, device) if cross else None

    @torch.no_grad()
    def init(self, cfg: ModelConfig, generator: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        init_attention_(self.attn, cfg, generator)
        _init_mlp_(self.mlp, generator)
        if self.xgate is not None:
            self.xgate.zero_()

    def forward(self, x: torch.Tensor, cfg: ModelConfig, is_global: bool = True, *,
                causal: bool = True, kv_x: torch.Tensor | None = None) -> torch.Tensor:
        h = attention(self.attn, rms_norm(x, self.ln1), cfg, is_global=is_global,
                      causal=causal, kv_x=kv_x)
        if self.xgate is not None:
            h = h * torch.tanh(self.xgate).to(h.dtype)
        x = x + h
        return x + mlp(self.mlp, rms_norm(x, self.ln2), cfg.mlp)


class MLABlock(nn.Module):
    """Pre-norm block of the moe family: ln1, attn (MLA), ln2, and either
    the dense MLP ``mlp`` (the first ``first_k_dense`` layers) or the
    routed and shared experts ``moe``."""

    def __init__(self, cfg: ModelConfig, device, use_moe: bool):
        super().__init__()
        self.ln1 = _param(cfg.d_model, torch.float32, device)
        self.attn = init_mla(cfg, device)
        self.ln2 = _param(cfg.d_model, torch.float32, device)
        self.mlp = None if use_moe else _init_mlp(cfg, device)
        self.moe = MoEParams(cfg, device) if use_moe else None

    @torch.no_grad()
    def init(self, cfg: ModelConfig, generator: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        init_mla_(self.attn, cfg, generator)
        if self.moe is not None:
            init_moe_(self.moe, cfg, generator)
        else:
            _init_mlp_(self.mlp, generator)

    def ffn(self, h: torch.Tensor, cfg: ModelConfig):
        """The block's second half on its normed input: (y, aux or None)."""
        if self.moe is not None:
            return moe_layer(self.moe, h, cfg)
        return mlp(self.mlp, h, cfg.mlp), None

    def forward(self, x: torch.Tensor, cfg: ModelConfig):
        x = x + mla_attention(self.attn, rms_norm(x, self.ln1), cfg)
        y, aux = self.ffn(rms_norm(x, self.ln2), cfg)
        return x + y, aux


class MambaBlock(nn.Module):
    """Pre-norm Mamba-2 block: x + mix(ln(x))."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln = _param(cfg.d_model, torch.float32, device)
        self.mix = init_mamba(cfg, device)

    @torch.no_grad()
    def init(self, cfg: ModelConfig, generator: torch.Generator) -> None:
        self.ln.zero_()
        init_mamba_(self.mix, cfg, generator)

    def forward(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        return x + mamba_forward(self.mix, rms_norm(x, self.ln), cfg)


class RGLRUBlock(nn.Module):
    """Pre-norm RG-LRU block: ln1, mix (the recurrence), ln2, mlp."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = _param(cfg.d_model, torch.float32, device)
        self.mix = init_rglru(cfg, device)
        self.ln2 = _param(cfg.d_model, torch.float32, device)
        self.mlp = _init_mlp(cfg, device)

    @torch.no_grad()
    def init(self, cfg: ModelConfig, generator: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        init_rglru_(self.mix, cfg, generator)
        _init_mlp_(self.mlp, generator)

    def forward(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        x = x + rglru_forward(self.mix, rms_norm(x, self.ln1), cfg)
        return x + mlp(self.mlp, rms_norm(x, self.ln2), cfg.mlp)


def _stack(make, n: int) -> nn.ModuleList:
    return nn.ModuleList(make() for _ in range(n))


def hybrid_periods(cfg: ModelConfig) -> tuple[int, int]:
    """(whole R R L periods, trailing recurrent layers): 26 layers are 8
    periods and 2 more RG-LRU blocks."""
    return divmod(cfg.num_layers, 3)


class LM(nn.Module):
    """One architecture: embedding, the family's blocks, final norm, tied
    or untied head (and whisper's encoder)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        fam = cfg.family
        if fam not in ("dense", "vlm", "moe", "ssm", "hybrid", "encdec"):
            raise ValueError(fam)
        dev = resolve_device(device)
        self.cfg = cfg
        self.flags = layer_flags(cfg)
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = _param((V, d), cfg.pdtype, dev)
        self.final_norm = _param(d, torch.float32, dev)
        if not cfg.tie_embeddings:
            self.unembed = _param((V, d), cfg.pdtype, dev)
        block = lambda **kw: (lambda: Block(cfg, dev, **kw))  # noqa: E731
        if fam == "dense":
            self.blocks = _stack(block(), cfg.num_layers)
        elif fam == "vlm":
            k = cfg.cross_attn_every
            n_p = cfg.num_layers // k
            self.self_blocks = _stack(lambda: _stack(block(), k - 1), n_p)
            self.cross_blocks = _stack(block(cross=True), n_p)
        elif fam == "moe":
            k = cfg.first_k_dense
            if k:
                self.dense_blocks = _stack(lambda: MLABlock(cfg, dev, use_moe=False), k)
            self.moe_blocks = _stack(lambda: MLABlock(cfg, dev, use_moe=True), cfg.num_layers - k)
        elif fam == "ssm":
            self.blocks = _stack(lambda: MambaBlock(cfg, dev), cfg.num_layers)
        elif fam == "hybrid":
            n_p, rem = hybrid_periods(cfg)
            self.rec_blocks = _stack(lambda: _stack(lambda: RGLRUBlock(cfg, dev), 2), n_p)
            self.attn_blocks = _stack(block(), n_p)
            if rem:
                self.extra_rec = _stack(lambda: RGLRUBlock(cfg, dev), rem)
        else:                                                   # encdec
            self.enc_blocks = _stack(block(), cfg.num_encoder_layers)
            self.enc_norm = _param(d, torch.float32, dev)
            self.dec_self = _stack(block(), cfg.num_layers)
            self.dec_cross = _stack(block(cross=True), cfg.num_layers)

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
        if hasattr(self, "enc_norm"):
            self.enc_norm.zero_()
        for m in self.modules():
            if isinstance(m, (Block, MLABlock, MambaBlock, RGLRUBlock)):
                m.init(self.cfg, generator)
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
    def forward(self, tokens: torch.Tensor, *, image_embeds: torch.Tensor | None = None,
                audio_embeds: torch.Tensor | None = None, last_only: bool = False):
        """tokens (B, S) → (logits, aux_loss); vlm takes ``image_embeds``
        (B, N, d), encdec ``audio_embeds`` (B, frames, d). ``last_only``
        (serving prefill) emits the final position's logits only, so the
        (B, S, V) tensor never exists. aux_loss is the float32 sum of the
        moe layers' load-balance losses (zero for the other families)."""
        x, aux = self._backbone(tokens, image_embeds=image_embeds, audio_embeds=audio_embeds)
        if last_only:
            x = x[:, -1:]
        return self._logits(x), aux

    def _backbone(self, tokens: torch.Tensor, *, image_embeds=None, audio_embeds=None):
        """tokens (B, S) → (final hidden states (B, S, d) before the final
        norm, aux loss), the layers in the reference's order. Dense layers
        run in order with their per-layer global flag (the reference's
        period-grouped L…G scan and its flag scan both reduce to this)."""
        cfg = self.cfg
        fam = cfg.family
        x = self._embed(tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if fam == "dense":
            for blk, is_global in zip(self.blocks, self.flags["is_global"]):
                x = blk(x, cfg, bool(is_global))
        elif fam == "vlm":
            if image_embeds is None:
                raise ValueError(f"{cfg.name}: the vlm family needs image_embeds")
            img = image_embeds.to(cfg.cdtype)
            for selfs, cross in zip(self.self_blocks, self.cross_blocks):
                for blk in selfs:
                    x = blk(x, cfg)
                x = cross(x, cfg, causal=False, kv_x=img)
        elif fam == "moe":
            for blk in getattr(self, "dense_blocks", ()):
                x, _ = blk(x, cfg)
            for blk in self.moe_blocks:
                x, a = blk(x, cfg)
                aux = aux + a
        elif fam == "ssm":
            for blk in self.blocks:
                x = blk(x, cfg)
        elif fam == "hybrid":
            for recs, attn in zip(self.rec_blocks, self.attn_blocks):
                for blk in recs:
                    x = blk(x, cfg)
                x = attn(x, cfg, is_global=False)
            for blk in getattr(self, "extra_rec", ()):
                x = blk(x, cfg)
        else:                                                   # encdec
            enc = self.encode(audio_embeds)
            for self_blk, cross in zip(self.dec_self, self.dec_cross):
                x = cross(self_blk(x, cfg), cfg, causal=False, kv_x=enc)
        return x, aux

    @torch.no_grad()
    def encode(self, audio_embeds: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder over precomputed (stub-frontend) frames
        (B, frames, d): non-causal self-attention with rotary embeddings,
        no window. Any number of frames: the reference's trainer feeds
        max(encoder_seq_len, 64) of them (launch/train.py), its serving
        paths encoder_seq_len; training is a later slice here."""
        if audio_embeds is None:
            raise ValueError(f"{self.cfg.name}: the encdec family needs audio_embeds")
        x = audio_embeds.to(self.cfg.cdtype)
        for blk in self.enc_blocks:
            x = blk(x, self.cfg, causal=False)
        return rms_norm(x, self.enc_norm)
