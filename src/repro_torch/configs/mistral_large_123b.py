"""mistral-large-123b [dense] — 88L d=12288 96H (GQA kv=8) d_ff=28672
vocab=32768, SwiGLU, full attention. [hf:mistralai/Mistral-Large-
Instruct-2407; unverified]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", family="dense",
        num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
        head_dim=128, d_ff=28672, vocab_size=32768,
        mlp="swiglu", tie_embeddings=False,
        layer_pattern="G", rope_theta=1_000_000.0, max_seq_len=131_072,
    )
