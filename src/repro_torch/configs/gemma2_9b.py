"""gemma2-9b [dense] — 42L d=3584 16H (GQA kv=8, head_dim=256)
d_ff=14336 vocab=256000, local+global alternating (window 4096),
attn/final logit softcaps 50/30. [arXiv:2408.00118; hf]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", family="dense",
        num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8,
        head_dim=256, d_ff=14336, vocab_size=256_000,
        mlp="geglu", tie_embeddings=True,
        layer_pattern="LG", local_window=4096,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        rope_theta=10_000.0, max_seq_len=8192,
    )
