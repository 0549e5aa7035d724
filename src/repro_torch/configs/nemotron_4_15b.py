"""nemotron-4-15b [dense] — 32L d=6144 48H (GQA kv=8) d_ff=24576
vocab=256000, squared-ReLU MLP, untied embeddings. [arXiv:2402.16819;
unverified]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=24576, vocab_size=256_000,
        mlp="squared_relu", tie_embeddings=False,
        layer_pattern="G", rope_theta=10_000.0, max_seq_len=4096,
    )
