"""llama-3.2-vision-11b [vlm] — 40L d=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; every 5th layer is a gated cross-attention (image)
layer; the vision frontend is a STUB (input_specs supplies projected
patch embeddings). [hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=128_256,
        mlp="swiglu", tie_embeddings=False,
        layer_pattern="G", rope_theta=500_000.0, max_seq_len=131_072,
        cross_attn_every=5, num_image_tokens=1601,
    )
