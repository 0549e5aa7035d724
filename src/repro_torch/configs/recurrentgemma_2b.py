"""recurrentgemma-2b [hybrid] — 26L d=2560 10H (MQA kv=1, head_dim
256) d_ff=7680 GeGLU, RG-LRU + local attention 2:1 (window 2048),
lru_width 2560. [arXiv:2402.19427; hf]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256_000,
        mlp="geglu", tie_embeddings=True,
        layer_pattern="RRL", local_window=2048, lru_width=2560,
        rope_theta=10_000.0, max_seq_len=1_048_576,
    )
