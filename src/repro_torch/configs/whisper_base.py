"""whisper-base [audio] — enc-dec, 6+6L d=512 8H d_ff=2048 GELU,
vocab 51865 (padded to 52224); conv frontend is a STUB (input_specs
supplies precomputed frame embeddings); positions via RoPE in this
port (learned-positional swap documented in DESIGN.md).
[arXiv:2212.04356; unverified]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="encdec",
        num_layers=6, num_encoder_layers=6,
        d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
        d_ff=2048, vocab_size=51_865,
        mlp="gelu", tie_embeddings=True,
        layer_pattern="G", rope_theta=10_000.0,
        max_seq_len=448, encoder_seq_len=1500,
    )
