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

An LM may hold one rank's blocks of its parameters under a mesh placed
over a process group (``placement``, a ``Placement``: set by
``runtime.train.place_``, which the sharded training and prefill steps
call). Its ``forward`` and ``loss`` then run on the rank's rows of the
batch, every family: the attention blocks through ``attention_sharded``
(causal or not, self or cross: the vlm's image layers, whisper's encoder
and its decoder's cross layers, the tanh gate applied after the
row-parallel sum), MLA through ``mla_sharded``, the RG-LRU blocks through
``rglru_sharded``, the Mamba-2 blocks through ``mamba_sharded``, every
MLP through ``mlp_sharded``, the routed experts through
``moe.moe_sharded`` (the gather dispatch of the sharded batch, or the
a2a). The embedding and the unembedding are used where they stand, as the
reference's rules cut them (vocab over 'model', width over 'data'):
each rank gathers its block over 'data' alone (ZeRO-3's gather) into its
rows [v0, v0 + V/m) of the table and never the table (``_table``), looks
tokens up in them (``layers.vocab_embed``, Megatron's vocab-parallel
embedding), computes its (…, V/m) block of the logits, gathered along V
over 'model' where whole rows are asked for (``forward``), and runs the
loss's chunks vocab-parallel (``_chunk_ce``: the max and the float32 sum
of exponentials and the picked logit over 'model'). Where the spec does
not cut the vocab over 'model' (m = 1, or V not divisible by it), the
table is whole after the 'data' gather and every path is the one
device's. ``loss`` is the global mean: the sums of nll and lse² and the
count of unmasked labels are summed over the mesh before the division,
each rank differentiating its share (``launch.mesh.sum_shares``); the
moe family's aux, the same global value on every rank, is counted once:
each rank's share is aux / world.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from .._device import resolve_device
from ..launch.mesh import all_gather, all_reduce, gather_dims, sum_shares
from .attention import attention, attention_sharded, init_attention, init_attention_, mlp_sharded
from .common import ModelConfig, layer_flags, torch_dtype
from .layers import embed, init_embedding_, init_linear_, mlp, rms_norm, softcap, vocab_embed
from .mla import init_mla, init_mla_, mla_attention, mla_sharded
from .moe import MoEParams, init_moe_, moe_layer, moe_sharded
from .rglru import init_rglru, init_rglru_, rglru_forward, rglru_sharded
from .ssm import init_mamba, init_mamba_, mamba_forward, mamba_sharded

__all__ = ["LM", "Block", "MLABlock", "MambaBlock", "RGLRUBlock", "Placement", "TableRows"]


@dataclass(frozen=True)
class Placement:
    """An LM's parameters as one rank's blocks: the mesh (placed over a
    process group), every parameter's spec (``runtime.sharding.param_specs``),
    and the number of ranks the batch rows are split over."""
    mesh: object
    specs: dict
    row_shards: int

    def under(self, prefix: str) -> dict:
        """The specs of module ``prefix``'s parameters, by their names in it."""
        return _under(self.specs, prefix)


class TableRows(NamedTuple):
    """A table (the embedding or the unembedding) as a rank uses it: its
    rows [v0, v0 + n) whole in d, and the mesh whose 'model' ranks hold the
    others (None: ``table`` is the whole table, v0 0)."""
    table: torch.Tensor
    v0: int = 0
    mesh: object = None

    @classmethod
    def of(cls, t: torch.Tensor, spec: tuple, mesh) -> "TableRows":
        """A rank's table ``t``, whole in d, held under ``spec``: its rows
        of the vocab where the spec cuts it over 'model', else the whole
        table."""
        if mesh is None or spec[0] != "model":
            return cls(t)
        return cls(t, mesh.coords["model"] * t.shape[0], mesh)


def _under(specs: dict, prefix: str) -> dict:
    p = prefix + "."
    return {k[len(p):]: s for k, s in specs.items() if k.startswith(p)}


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
                causal: bool = True, kv_x: torch.Tensor | None = None,
                mesh=None, specs: dict | None = None) -> torch.Tensor:
        if mesh is not None:        # a rank's blocks, cut by ``specs``: the sharded attention and MLP
            h = attention_sharded(self.attn, rms_norm(x, self.ln1), cfg, mesh, _under(specs, "attn"),
                                  is_global=is_global, causal=causal, kv_x=kv_x)
            if self.xgate is not None:
                h = h * torch.tanh(self.xgate).to(h.dtype)
            x = x + h
            return x + mlp_sharded(self.mlp, rms_norm(x, self.ln2), cfg, mesh, _under(specs, "mlp"))
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

    def forward(self, x: torch.Tensor, cfg: ModelConfig, *, mesh=None, specs: dict | None = None):
        if mesh is not None:        # a rank's blocks, cut by ``specs``: the sharded MLA, MLP or experts
            x = x + mla_sharded(self.attn, rms_norm(x, self.ln1), cfg, mesh, _under(specs, "attn"))
            h = rms_norm(x, self.ln2)
            if self.moe is not None:
                y, aux = moe_sharded(self.moe, h, cfg, mesh, _under(specs, "moe"))
            else:
                y, aux = mlp_sharded(self.mlp, h, cfg, mesh, _under(specs, "mlp")), None
            return x + y, aux
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

    def forward(self, x: torch.Tensor, cfg: ModelConfig, *, mesh=None, specs: dict | None = None) -> torch.Tensor:
        if mesh is not None:        # a rank's blocks, cut by ``specs``: the sharded Mamba-2 mixer
            return x + mamba_sharded(self.mix, rms_norm(x, self.ln), cfg, mesh, _under(specs, "mix"))
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

    def forward(self, x: torch.Tensor, cfg: ModelConfig, *, mesh=None, specs: dict | None = None) -> torch.Tensor:
        if mesh is not None:        # a rank's blocks, cut by ``specs``: the sharded RG-LRU and MLP
            x = x + rglru_sharded(self.mix, rms_norm(x, self.ln1), cfg, mesh, _under(specs, "mix"))
            return x + mlp_sharded(self.mlp, rms_norm(x, self.ln2), cfg, mesh, _under(specs, "mlp"))
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
        self.placement: Placement | None = None
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
    def _table(self, name: str) -> TableRows:
        """Parameter ``name`` (``embed`` or ``unembed``) as this rank uses it:
        without a placement the whole table; under one the rank's block
        gathered over 'data' alone (its gradient comes back through the
        gather), which is its rows of the table where the spec cuts the
        vocab over 'model', and the whole table where it does not."""
        t = getattr(self, name)
        place = self.placement
        if place is None:
            return TableRows(t)
        spec = place.specs[name]
        return TableRows.of(gather_dims(t, spec, place.mesh, axes=("data",)), spec, place.mesh)

    def _head(self, rows: TableRows) -> TableRows:
        """The output projection's table: the embedding's ``rows`` when tied,
        else the unembedding's."""
        return rows if self.cfg.tie_embeddings else self._table("unembed")

    def _embed(self, tokens: torch.Tensor, rows: TableRows | None = None) -> torch.Tensor:
        cfg = self.cfg
        table, v0, mesh = rows or TableRows(self.embed)
        if mesh is None:
            x = embed(tokens, table)
        else:
            x = vocab_embed(tokens, table, v0, mesh)
        x = x.to(cfg.cdtype)
        # the scale is rounded to the compute type first (√3584 → 59.75 in bf16)
        return x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype, device=x.device)

    def _logits(self, x: torch.Tensor, rows: TableRows | None = None) -> torch.Tensor:
        """Float32 logits of the hidden states ``x`` (before the final
        norm), whole along V: under ``rows``' mesh the rank's block of
        them, gathered over 'model'."""
        table, _, mesh = rows or TableRows(self.embed if self.cfg.tie_embeddings else self.unembed)
        h = rms_norm(x, self.final_norm)
        return self._vocab_logits(torch.matmul(h, table.t()).to(torch.float32), mesh)   # product in the compute type

    def _vocab_logits(self, logits: torch.Tensor, mesh=None) -> torch.Tensor:
        """Soft-capped logits; under ``mesh`` the ranks' blocks along V
        (this rank's ``logits``) gathered over 'model', in coordinate order."""
        logits = softcap(logits, self.cfg.final_logit_softcap)
        if mesh is None:
            return logits
        return all_gather(logits, "model", mesh, dim=-1)

    # ---------------- forward (prefill) ----------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *, image_embeds: torch.Tensor | None = None,
                audio_embeds: torch.Tensor | None = None, last_only: bool = False):
        """tokens (B, S) → (logits, aux_loss); vlm takes ``image_embeds``
        (B, N, d), encdec ``audio_embeds`` (B, frames, d). ``last_only``
        (serving prefill) emits the final position's logits only, so the
        (B, S, V) tensor never exists. aux_loss is the float32 sum of the
        moe layers' load-balance losses (zero for the other families)."""
        x, aux, rows = self._backbone(tokens, image_embeds=image_embeds, audio_embeds=audio_embeds)
        if last_only:
            x = x[:, -1:]
        return self._logits(x, self._head(rows)), aux

    def _backbone(self, tokens: torch.Tensor, *, image_embeds=None, audio_embeds=None):
        """tokens (B, S) → (final hidden states (B, S, d) before the final
        norm, aux loss, the embedding's ``TableRows`` used), the layers in the
        reference's order. Dense layers run in order with their per-layer
        global flag (the reference's period-grouped L…G scan and its flag
        scan both reduce to this)."""
        cfg = self.cfg
        fam = cfg.family
        on = self._on
        rows = self._table("embed")
        x = self._embed(tokens, rows)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if fam == "dense":
            for i, (blk, is_global) in enumerate(zip(self.blocks, self.flags["is_global"])):
                x = self._block(blk, x, cfg, bool(is_global), **on(f"blocks.{i}"))
        elif fam == "vlm":
            if image_embeds is None:
                raise ValueError(f"{cfg.name}: the vlm family needs image_embeds")
            img = image_embeds.to(cfg.cdtype)
            for p, (selfs, cross) in enumerate(zip(self.self_blocks, self.cross_blocks)):
                for j, blk in enumerate(selfs):
                    x = self._block(blk, x, cfg, **on(f"self_blocks.{p}.{j}"))
                x = self._block(cross, x, cfg, causal=False, kv_x=img, **on(f"cross_blocks.{p}"))
        elif fam == "moe":
            for i, blk in enumerate(getattr(self, "dense_blocks", ())):
                x, _ = self._block(blk, x, cfg, **on(f"dense_blocks.{i}"))
            for i, blk in enumerate(self.moe_blocks):
                x, a = self._block(blk, x, cfg, **on(f"moe_blocks.{i}"))
                aux = aux + a
        elif fam == "ssm":
            for i, blk in enumerate(self.blocks):
                x = self._block(blk, x, cfg, **on(f"blocks.{i}"))
        elif fam == "hybrid":
            for p, (recs, attn) in enumerate(zip(self.rec_blocks, self.attn_blocks)):
                for j, blk in enumerate(recs):
                    x = self._block(blk, x, cfg, **on(f"rec_blocks.{p}.{j}"))
                x = self._block(attn, x, cfg, is_global=False, **on(f"attn_blocks.{p}"))
            for i, blk in enumerate(getattr(self, "extra_rec", ())):
                x = self._block(blk, x, cfg, **on(f"extra_rec.{i}"))
        else:                                                   # encdec
            enc = self._encode(audio_embeds)
            for i, (self_blk, cross) in enumerate(zip(self.dec_self, self.dec_cross)):
                # one body a decoder layer, as the reference's remat groups them
                def layer(h, s=self_blk, c=cross, i=i):
                    h = s(h, cfg, **on(f"dec_self.{i}"))
                    return c(h, cfg, causal=False, kv_x=enc, **on(f"dec_cross.{i}"))
                x = self._block(layer, x)
        return x, aux, rows

    def _on(self, prefix: str) -> dict:
        """The keywords that run module ``prefix`` on this rank's blocks under
        the placement (none without one)."""
        place = self.placement
        return {} if place is None else {"mesh": place.mesh, "specs": place.under(prefix)}

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
        for i, blk in enumerate(self.enc_blocks):
            x = self._block(blk, x, self.cfg, causal=False, **self._on(f"enc_blocks.{i}"))
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
        masked out.

        Under a placement ``batch`` holds this rank's rows of a global
        batch split over the mesh's batch axes
        (``runtime.sharding.batch_axes``); the chunk count is the global
        batch's, the sums and the count are the whole
        mesh's, and the returned values are the global ones on every rank,
        whose gradients reach each rank's share: its rows' sums over the
        global count, times 1/m (the 'model' ranks hold the same rows). The
        moe family's aux is the global one on every rank, and each rank's
        share of it is aux / world. Each chunk's logits are the rank's
        (…, V/m) block where the vocab is cut over 'model' (``_chunk_ce``)."""
        cfg = self.cfg
        x, aux, rows = self._backbone(batch["tokens"], image_embeds=batch.get("image_embeds"),
                                      audio_embeds=batch.get("audio_embeds"))
        table, v0, vmesh = self._head(rows)
        labels = batch["labels"]
        B, S, _ = x.shape
        place = self.placement
        rows = B * (1 if place is None else place.row_shards)
        n = ce_chunks(rows, S, cfg.padded_vocab, self._CE_CHUNK_BUDGET, self._CE_MAX_CHUNKS)
        C = S // n
        nll = zsq = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = 0
        for i in range(n):
            a, b, c = checkpoint(self._chunk_ce, x[:, i * C:(i + 1) * C], labels[:, i * C:(i + 1) * C], table, v0,
                                 vmesh, use_reentrant=False)
            nll, zsq, cnt = nll + a, zsq + b, cnt + c
        cnt = torch.as_tensor(cnt, device=x.device)
        if place is None:
            denom = torch.clamp(cnt, min=1)
            ce = nll / denom
            zloss = cfg.z_loss * (zsq / denom)
            return ce + zloss + aux, {"ce": ce, "z_loss": zloss, "aux": aux}
        mesh = place.mesh
        m = mesh.get("model", 1)
        denom = torch.clamp(all_reduce(cnt, None, mesh) // m, min=1)
        ce = sum_shares(nll / denom / m, mesh)
        zloss = sum_shares(cfg.z_loss * (zsq / denom) / m, mesh)
        if cfg.family == "moe":
            aux = sum_shares(aux / math.prod(mesh.values()), mesh)
        return ce + zloss + aux, {"ce": ce, "z_loss": zloss, "aux": aux}

    def _chunk_ce(self, x_c: torch.Tensor, labels_c: torch.Tensor, table: torch.Tensor, v0: int = 0, mesh=None):
        """One chunk's (Σ nll, Σ lse², count of unmasked labels), ``table``
        the output projection's (V, d); under ``mesh`` its rows [v0, v0 +
        V/m), the logits the rank's block of them and the lse and the
        picked logit summed over 'model' (``vocab_lse``)."""
        cfg = self.cfg
        h = rms_norm(x_c, self.final_norm)
        logits = torch.matmul(h, table.t()).to(torch_dtype(cfg.logits_dtype))
        logits = softcap(logits, cfg.final_logit_softcap)
        mask = (labels_c >= 0) & (labels_c < cfg.vocab_size)
        if mesh is None:
            safe = torch.where(mask, labels_c, 0).long()
            lse = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, -1, safe[..., None])[..., 0]
        else:
            lse, picked = vocab_lse(logits, labels_c, mask, v0, mesh)
        nll = torch.where(mask, lse - picked, 0.0)
        zsq = torch.where(mask, torch.square(lse), 0.0)
        return nll.sum(), zsq.sum(), mask.sum()


def vocab_lse(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, v0: int, mesh):
    """(lse, picked logit) over the whole vocab from this rank's block of
    the logits (…, n), its columns [v0, v0 + n) (Megatron's vocab-parallel
    cross entropy): the max over 'model' (detached: the lse does not depend
    on the shift), the float32 sum of exponentials below it summed over
    'model', lse = max + log(sum); the picked logit the rank's own where the
    label (unmasked) falls in its columns, else 0, summed over 'model'."""
    mx = all_reduce(logits.detach().amax(dim=-1), "model", mesh, op="max").float()
    total = all_reduce(torch.exp(logits.float() - mx[..., None]).sum(dim=-1), "model", mesh)
    lse = (mx + torch.log(total)).to(logits.dtype)
    local = labels - v0
    inside = mask & (local >= 0) & (local < logits.shape[-1])
    own = torch.gather(logits, -1, torch.where(inside, local, 0).long()[..., None])[..., 0]
    picked = all_reduce(torch.where(inside, own, 0.0), "model", mesh)
    return lse, picked
