"""gemma3-12b [dense] — 48L d=3840 16H (GQA kv=8, head_dim=256)
d_ff=15360 vocab=262144, 5:1 local:global (window 1024), dual RoPE
theta (10k local / 1M global), QK-norm. [hf:google/gemma-3-12b-pt;
unverified]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="dense",
        num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
        head_dim=256, d_ff=15360, vocab_size=262144,
        mlp="geglu", tie_embeddings=True,
        layer_pattern="LLLLLG", local_window=1024,
        rope_theta=10_000.0, rope_theta_global=1_000_000.0,
        qk_norm=True, max_seq_len=131_072,
    )
