"""deepseek-v2-236b [moe] — 60L d=5120 128H MLA (kv_lora 512), 2
shared + 160 routed experts top-6 (expert d_ff 1536, dense-layer d_ff
12288, first layer dense), softmax router, vocab 102400.
[arXiv:2405.04434; hf]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
        d_ff=12288, vocab_size=102_400,
        mlp="swiglu", tie_embeddings=False,
        layer_pattern="G", rope_theta=10_000.0, max_seq_len=131_072,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        num_experts=160, num_shared_experts=2, top_k=6,
        moe_d_ff=1536, first_k_dense=1, router="softmax",
    )
