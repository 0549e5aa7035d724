"""Model configuration covering all ten assigned architectures.

One ``ModelConfig`` describes any family; family-specific fields are
ignored elsewhere. The same dataclass as ``repro.models.common``, field
for field, so a configuration means the same model in both packages;
``pdtype``/``cdtype`` return torch dtypes here. Layer patterns
(local:global, RG-LRU:attention, dense-then-MoE) are encoded as
per-layer flag arrays (``layer_flags``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal, Optional

import numpy as np
import torch

__all__ = ["ModelConfig", "round_up", "layer_flags", "torch_dtype"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"`` …)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype name {name!r}; choose from {sorted(_DTYPES)}") from None


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"] = "dense"

    # -- transformer core --
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                 # 0 → d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    max_seq_len: int = 8192
    mlp: Literal["swiglu", "geglu", "squared_relu", "gelu"] = "swiglu"
    tie_embeddings: bool = True

    # attention flavour
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0    # gemma3: global layers use 1e6
    attn_logit_softcap: float = 0.0   # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    qk_norm: bool = False             # gemma3
    local_window: int = 0             # sliding-window size for local layers
    # layer pattern string, cycled over layers: 'L'=local attn, 'G'=global
    # attn, 'R'=recurrent (RG-LRU), 'M'=mamba2 (SSD). e.g. gemma3:
    # 'LLLLLG', gemma2: 'LG', recurrentgemma: 'RRG', mamba2: 'M'
    layer_pattern: str = "G"

    # -- MoE --
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router: Literal["softmax", "sigmoid"] = "softmax"
    aux_loss_coef: float = 0.001

    # -- MLA (DeepSeek) --
    use_mla: bool = False
    q_lora_rank: int = 0              # 0 → full-rank q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # -- Mamba2 / SSD --
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # -- RG-LRU (RecurrentGemma) --
    lru_width: int = 0                # 0 → d_model

    # -- encoder-decoder (whisper) --
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0          # stub frontend emits this many frames

    # -- VLM (llama-3.2-vision) --
    cross_attn_every: int = 0         # a cross-attn layer every k layers
    num_image_tokens: int = 0

    # -- numerics --
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logits_dtype: str = "float32"

    # -- training extras --
    remat: bool = True
    # 'full' recomputes everything; 'dots' saves matmul outputs (skips
    # recomputing projections AND their ZeRO gathers in backward)
    remat_policy: str = "full"
    z_loss: float = 1e-4

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 so it shards over any mesh axis (logits
        for pad ids are masked at the loss)."""
        return round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:          # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def lru_width_(self) -> int:
        return self.lru_width or self.d_model

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def pattern_for(self, num_layers: Optional[int] = None) -> str:
        n = num_layers if num_layers is not None else self.num_layers
        pat = (self.layer_pattern * (n // len(self.layer_pattern) + 1))[:n]
        return pat

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized config of the same family (small layers,
        few experts, tiny vocab) — used by per-arch smoke tests."""
        p = len(self.layer_pattern)
        n_reduced = p * max(1, round(4 / p)) if p > 1 else min(self.num_layers, 4)
        kw: dict = dict(
            num_layers=min(self.num_layers, n_reduced),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) or 4,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            max_seq_len=256,
        )
        if self.num_experts:
            kw.update(num_experts=8, top_k=2, moe_d_ff=64,
                      num_shared_experts=min(self.num_shared_experts, 1),
                      first_k_dense=min(self.first_k_dense, 1))
        if self.use_mla:
            kw.update(q_lora_rank=(64 if self.q_lora_rank else 0),
                      kv_lora_rank=32, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32)
        if self.family == "ssm":
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if self.family == "hybrid":
            # 1 full RRL period + 2 trailing R layers → covers extra_rec
            kw.update(lru_width=128, local_window=64, num_layers=5)
        if self.local_window:
            kw.update(local_window=min(self.local_window, 64))
        if self.num_encoder_layers:
            kw.update(num_encoder_layers=2, encoder_seq_len=64)
        if self.cross_attn_every:
            kw.update(num_image_tokens=16)
        kw.update(overrides)
        return self.replace(**kw)


def layer_flags(cfg: ModelConfig) -> dict[str, np.ndarray]:
    """Per-layer flag arrays derived from the layer pattern."""
    pat = cfg.pattern_for()
    return {
        "is_global": np.array([c == "G" for c in pat], np.bool_),
        "is_recurrent": np.array([c in ("R", "M") for c in pat], np.bool_),
        "is_moe": np.array(
            [cfg.num_experts > 0 and i >= cfg.first_k_dense for i in range(cfg.num_layers)],
            np.bool_,
        ),
        "is_cross": np.array(
            [
                cfg.cross_attn_every > 0 and (i % cfg.cross_attn_every == cfg.cross_attn_every - 1)
                for i in range(cfg.num_layers)
            ],
            np.bool_,
        ),
    }
