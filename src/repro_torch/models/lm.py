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

Parameters are created with ``requires_grad`` off, and ``forward``,
``encode`` and the decode path (``models.decode``) run under
``torch.no_grad()``: serving builds no autograd graph. Training
(``runtime.train``) turns grads on with ``lm.requires_grad_(True)`` and
differentiates ``loss``, the reference's sequence-chunked cross entropy
with each chunk recomputed in backward. With ``cfg.remat`` every block
of the backbone is recomputed in backward too
(``torch.utils.checkpoint``; ``remat_policy="dots"`` keeps the blocks'
matrix-product outputs, as the reference's
``dots_with_no_batch_dims_saveable``), so on the card the flash kernel
runs once more a layer.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from .._device import resolve_device
from .attention import attention, init_attention, init_attention_
from .common import ModelConfig, layer_flags, torch_dtype
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


# Matrix products without batch dimensions, the outputs remat_policy="dots"
# keeps (a 3-D activation times a 2-D weight reaches aten.mm).
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def ce_chunks(B: int, S: int, V: int, budget: int, max_chunks: int) -> int:
    """The reference's cross-entropy chunk count: the largest divisor of
    S at most max(1, min(B·S·V // budget, max_chunks, S))."""
    target = max(1, min((B * S * V) // budget, max_chunks, S))
    return next(c for c in range(target, 0, -1) if S % c == 0)


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
                x = self._block(blk, x, cfg, bool(is_global))
        elif fam == "vlm":
            if image_embeds is None:
                raise ValueError(f"{cfg.name}: the vlm family needs image_embeds")
            img = image_embeds.to(cfg.cdtype)
            for selfs, cross in zip(self.self_blocks, self.cross_blocks):
                for blk in selfs:
                    x = self._block(blk, x, cfg)
                x = self._block(cross, x, cfg, causal=False, kv_x=img)
        elif fam == "moe":
            for blk in getattr(self, "dense_blocks", ()):
                x, _ = self._block(blk, x, cfg)
            for blk in self.moe_blocks:
                x, a = self._block(blk, x, cfg)
                aux = aux + a
        elif fam == "ssm":
            for blk in self.blocks:
                x = self._block(blk, x, cfg)
        elif fam == "hybrid":
            for recs, attn in zip(self.rec_blocks, self.attn_blocks):
                for blk in recs:
                    x = self._block(blk, x, cfg)
                x = self._block(attn, x, cfg, is_global=False)
            for blk in getattr(self, "extra_rec", ()):
                x = self._block(blk, x, cfg)
        else:                                                   # encdec
            enc = self._encode(audio_embeds)
            for self_blk, cross in zip(self.dec_self, self.dec_cross):
                # one body a decoder layer, as the reference's remat groups them
                x = self._block(lambda h, s=self_blk, c=cross: c(s(h, cfg), cfg, causal=False, kv_x=enc), x)
        return x, aux

    def _block(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, recomputed in backward under ``cfg.remat``
        (the reference's ``_maybe_remat``) when grads are on."""
        cfg = self.cfg
        if not (cfg.remat and torch.is_grad_enabled()):
            return fn(*args, **kwargs)
        if cfg.remat_policy == "dots":
            kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)

    @torch.no_grad()
    def encode(self, audio_embeds: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder over precomputed (stub-frontend) frames
        (B, frames, d): non-causal self-attention with rotary embeddings,
        no window. Any number of frames: the reference's trainer feeds
        max(encoder_seq_len, 64) of them (launch/train.py), its serving
        paths encoder_seq_len."""
        return self._encode(audio_embeds)

    def _encode(self, audio_embeds: torch.Tensor) -> torch.Tensor:
        if audio_embeds is None:
            raise ValueError(f"{self.cfg.name}: the encdec family needs audio_embeds")
        x = audio_embeds.to(self.cfg.cdtype)
        for blk in self.enc_blocks:
            x = self._block(blk, x, self.cfg, causal=False)
        return rms_norm(x, self.enc_norm)

    # ---------------- loss ----------------
    # target live-logit footprint per CE chunk, in float32 elements
    _CE_CHUNK_BUDGET = 2 ** 31
    _CE_MAX_CHUNKS = 512

    def loss(self, batch: dict):
        """Sequence-chunked cross entropy (+ z-loss, + the moe family's aux):
        (total, {"ce", "z_loss", "aux"}), float32 scalars. ``batch`` holds
        ``tokens`` and ``labels`` (B, S) (and ``image_embeds`` /
        ``audio_embeds`` for vlm / encdec). The (B, S, V) logits never
        exist whole: each chunk of positions is normed, projected,
        soft-capped and reduced, and recomputed in backward
        (``torch.utils.checkpoint``). Labels outside [0, vocab_size) are
        masked out."""
        cfg = self.cfg
        x, aux = self._backbone(batch["tokens"], image_embeds=batch.get("image_embeds"),
                                audio_embeds=batch.get("audio_embeds"))
        labels = batch["labels"]
        B, S, _ = x.shape
        n = ce_chunks(B, S, cfg.padded_vocab, self._CE_CHUNK_BUDGET, self._CE_MAX_CHUNKS)
        C = S // n
        nll = zsq = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = 0
        for i in range(n):
            a, b, c = checkpoint(self._chunk_ce, x[:, i * C:(i + 1) * C], labels[:, i * C:(i + 1) * C],
                                 use_reentrant=False)
            nll, zsq, cnt = nll + a, zsq + b, cnt + c
        denom = torch.clamp(torch.as_tensor(cnt, device=x.device), min=1)
        ce = nll / denom
        zloss = cfg.z_loss * (zsq / denom)
        return ce + zloss + aux, {"ce": ce, "z_loss": zloss, "aux": aux}

    def _chunk_ce(self, x_c: torch.Tensor, labels_c: torch.Tensor):
        """One chunk's (Σ nll, Σ lse², count of unmasked labels)."""
        cfg = self.cfg
        h = rms_norm(x_c, self.final_norm)
        table = self.embed if cfg.tie_embeddings else self.unembed
        logits = torch.matmul(h, table.t()).to(torch_dtype(cfg.logits_dtype))
        logits = softcap(logits, cfg.final_logit_softcap)
        mask = (labels_c >= 0) & (labels_c < cfg.vocab_size)
        safe = torch.where(mask, labels_c, 0).long()
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, safe[..., None])[..., 0]
        nll = torch.where(mask, lse - picked, 0.0)
        zsq = torch.where(mask, torch.square(lse), 0.0)
        return nll.sum(), zsq.sum(), mask.sum()
