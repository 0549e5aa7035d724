"""deepseek-v3-671b [moe] — 61L d=7168 128H MLA (q_lora 1536, kv_lora
512, nope/rope/v head dims 128/64/128), 1 shared + 256 routed experts
top-8 (expert d_ff 2048, dense-layer d_ff 18432, first 3 layers
dense), sigmoid router, vocab 129280. MTP head omitted (documented in
DESIGN.md). [arXiv:2412.19437; hf]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
        d_ff=18432, vocab_size=129_280,
        mlp="swiglu", tie_embeddings=False,
        layer_pattern="G", rope_theta=10_000.0, max_seq_len=131_072,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        num_experts=256, num_shared_experts=1, top_k=8,
        moe_d_ff=2048, first_k_dense=3, router="sigmoid",
    )
