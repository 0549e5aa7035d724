"""mamba2-780m [ssm] — 48L d=1536, attention-free SSD (state-space
duality), ssm_state=128, expand 2, head_dim 64, vocab 50280 (padded to
50432 for sharding). [arXiv:2405.21060; unverified]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        num_layers=48, d_model=1536, num_heads=1, num_kv_heads=1,
        head_dim=64, d_ff=0, vocab_size=50_280,
        tie_embeddings=True, layer_pattern="M",
        ssm_state=128, ssm_expand=2, ssm_head_dim=64,
        ssm_conv_width=4, ssm_chunk=256, ssm_ngroups=1,
        max_seq_len=1_048_576,
    )
