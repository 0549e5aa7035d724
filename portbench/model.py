"""The system under test, built from a configuration file, and its weights.

``port_config`` reads a configuration file (Hugging Face style keys, as
``configs/<name>.json`` holds them) into the port's ``ModelConfig`` and
refuses a value the port does not compute as stated, so that the file
says what runs. ``build`` allocates the port's ``LM`` on the device and
``fill_weights`` fills it from the seed on the device, with the
benchmark's own scheme: each product's matrix N(0, 1)/√fan_in, the
tables N(0, 1)·0.02, the norms' stored (scale − 1) N(0, 1)·0.1, in the
type each parameter is served in. The reference gets the same tensors.
"""
from __future__ import annotations

import math

import torch

__all__ = ["port_config", "build", "fill_weights", "named_weights"]

# Values the port computes and no key of its ModelConfig selects: a file
# that states another is refused.
_FIXED = {
    "attention_bias": False, "mlp_bias": False, "rms_norm_eps": 1e-6, "partial_rotary_factor": 1.0,
    "rope_scaling": None, "routed_scaling_factor": 1.0, "norm_topk_prob": True, "topk_method": "greedy",
    "scoring_func": "softmax", "moe_layer_freq": 1,
}
_MLP = {"silu": "swiglu", "relu2": "squared_relu"}


def port_config(cfg: dict):
    """The port's ``ModelConfig`` for a configuration file."""
    from repro_torch.models.common import ModelConfig

    for key, want in _FIXED.items():
        if key in cfg and cfg[key] != want:
            raise ValueError(f"{cfg.get('model_type')}: the port computes {key}={want!r}, the file says {cfg[key]!r}")
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    kw = dict(
        name=cfg["model_type"], family="dense", num_layers=cfg["num_hidden_layers"], d_model=d,
        num_heads=H, num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg.get("head_dim") or 0,
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"], max_seq_len=cfg["max_position_embeddings"],
        mlp=_MLP[cfg["hidden_act"]], tie_embeddings=cfg["tie_word_embeddings"], layer_pattern="G",
        rope_theta=float(cfg["rope_theta"]), param_dtype=cfg["torch_dtype"], compute_dtype=cfg["torch_dtype"],
        logits_dtype="float32",
    )
    if cfg.get("kv_lora_rank"):
        kw.update(use_mla=True, q_lora_rank=cfg["q_lora_rank"] or 0, kv_lora_rank=cfg["kv_lora_rank"],
                  qk_nope_head_dim=cfg["qk_nope_head_dim"], qk_rope_head_dim=cfg["qk_rope_head_dim"],
                  v_head_dim=cfg["v_head_dim"])
    if cfg.get("n_routed_experts"):
        kw.update(family="moe", num_experts=cfg["n_routed_experts"], num_shared_experts=cfg["n_shared_experts"],
                  top_k=cfg["num_experts_per_tok"], moe_d_ff=cfg["moe_intermediate_size"],
                  first_k_dense=cfg["first_k_dense_replace"], capacity_factor=cfg["capacity_factor"],
                  router=cfg["scoring_func"])
    return ModelConfig(**kw)


def build(cfg: dict, device):
    """The port's LM for ``cfg``, its parameters allocated on ``device`` (unfilled)."""
    from repro_torch.models import LM

    return LM(port_config(cfg), device=device)


def _fan_in(name: str, shape: tuple) -> int:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "wo":                        # (H, dv, d)
        return math.prod(shape[:-1])
    if ".moe." in f".{name}" and len(shape) == 3:   # routed experts (E, d, f) / (E, f, d)
        return shape[1]
    return shape[0]


def _std(name: str, shape: tuple) -> float:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("embed", "unembed"):
        return 0.02
    if len(shape) == 1:                     # a norm's stored (scale − 1)
        return 0.1
    return 1.0 / math.sqrt(_fan_in(name, shape))


@torch.no_grad()
def fill_weights(lm, seed: int) -> None:
    """Every parameter of ``lm`` drawn in place from one generator on its
    device, in ``named_parameters`` order: the same seed gives the same
    weights."""
    g = torch.Generator(device=lm.device)
    g.manual_seed(int(seed) % 2 ** 63)
    for name, p in lm.named_parameters():
        p.normal_(0.0, _std(name, tuple(p.shape)), generator=g)


def named_weights(lm) -> dict[str, torch.Tensor]:
    """The tensors the reference reads, by the port's parameter names."""
    return {name: p.detach() for name, p in lm.named_parameters()}
