"""FLOP and byte arithmetic of the benchmark's configurations.

Everything here is computed from a configuration file's published widths
(the Hugging Face style keys of ``portbench/configs/<name>.json``) and
from the data sheet's peaks in ``peaks.json``. It is the benchmark's own
yardstick: the program's counters and its dry run are not read for it,
so a change to the program cannot move it.

Conventions:

- A matrix product of an m-vector by an (m, n) matrix is 2·m·n FLOPs.
- A token's model FLOPs are twice the parameters of every product it
  passes through (the head included, the input embedding not: a lookup
  is no product; a routed layer counts its router, its top-k experts and
  its shared experts), plus attention over the keys at positions 0…pos:
  2·H·(d_qk + d_v) a key and layer (scores and values).
- A decode step reads every weight once but the input table, of which it
  reads only its rows.
"""
from __future__ import annotations

import json
from pathlib import Path

__all__ = ["PEAKS", "is_moe", "params", "total_params", "weight_bytes_per_step", "matmul_params_per_token",
           "attention_flops", "token_flops", "kv_cache_bytes", "decode_attention_work"]

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def is_moe(cfg: dict) -> bool:
    return bool(cfg.get("n_routed_experts"))


def _heads(cfg: dict) -> tuple[int, int, int, int]:
    """(H, KV, d_qk, d_v) of a layer's attention."""
    H = cfg["num_attention_heads"]
    if cfg.get("kv_lora_rank"):
        return H, H, cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    D = cfg.get("head_dim") or cfg["hidden_size"] // H
    return H, cfg["num_key_value_heads"], D, D


def _mlp_params(d: int, f: int, act: str) -> int:
    return (3 if act == "silu" else 2) * d * f   # gated (SwiGLU) or not (squared ReLU)


def params(cfg: dict) -> dict[str, int]:
    """Parameter counts by part, summed over the layers: ``attention``,
    ``mlp`` (dense layers), ``router``, ``experts`` (every routed expert),
    ``shared``, ``norms`` (float32), ``embed`` and ``unembed``."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, KV, dqk, dv = _heads(cfg)
    act = cfg["hidden_act"]
    if cfg.get("kv_lora_rank"):
        rq, rkv, dr = cfg["q_lora_rank"], cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
        q = d * rq + rq * H * dqk if rq else d * H * dqk
        attn = q + d * (rkv + dr) + rkv * H * (cfg["qk_nope_head_dim"] + dv) + H * dv * d
        attn_norms = (rq or 0) + rkv
    else:
        attn = d * H * dqk + 2 * d * KV * dqk + H * dv * d
        attn_norms = 0
    dense = cfg.get("first_k_dense_replace", 0) if is_moe(cfg) else L
    routed = L - dense
    out = {"attention": L * attn, "mlp": dense * _mlp_params(d, cfg["intermediate_size"], act),
           "router": 0, "experts": 0, "shared": 0,
           "norms": L * (2 * d + attn_norms) + d, "embed": cfg["vocab_size"] * d,
           "unembed": 0 if cfg.get("tie_word_embeddings") else cfg["vocab_size"] * d}
    if routed:
        E, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        out["router"] = routed * d * E
        out["experts"] = routed * E * 3 * d * f
        out["shared"] = routed * 3 * d * f * cfg.get("n_shared_experts", 0)
    return out


def total_params(cfg: dict) -> int:
    return sum(params(cfg).values())


def weight_bytes_per_step(cfg: dict) -> int:
    """Bytes of weights one decode step reads when every expert is hit:
    the bf16 products' once, the float32 router and norms' once, the
    input table not at all."""
    p = params(cfg)
    bf16 = p["attention"] + p["mlp"] + p["experts"] + p["shared"] + (p["unembed"] or p["embed"])
    return 2 * bf16 + 4 * (p["router"] + p["norms"])


def matmul_params_per_token(cfg: dict) -> int:
    """Parameters of the products one token passes through (head
    included, input embedding not; a routed layer's top-k experts only)."""
    p = params(cfg)
    n = p["attention"] + p["mlp"] + p["router"] + p["shared"] + (p["unembed"] or p["embed"])
    if is_moe(cfg):
        routed = cfg["num_hidden_layers"] - cfg.get("first_k_dense_replace", 0)
        n += routed * cfg["num_experts_per_tok"] * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]
    return n


def attention_flops(cfg: dict, pos: int) -> int:
    """Scores and values of one token at position ``pos`` over keys 0…pos, every layer."""
    H, _, dqk, dv = _heads(cfg)
    return cfg["num_hidden_layers"] * 2 * H * (dqk + dv) * (pos + 1)


def token_flops(cfg: dict, pos: int) -> int:
    return 2 * matmul_params_per_token(cfg) + attention_flops(cfg, pos)


def kv_cache_bytes(cfg: dict, slots: int, max_len: int, itemsize: int = 2) -> int:
    """The decode cache: MLA's latent and rotary key a token and layer, or
    K and V of every kv head."""
    L = cfg["num_hidden_layers"]
    if cfg.get("kv_lora_rank"):
        per = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    else:
        _, KV, D, _ = _heads(cfg)
        per = 2 * KV * D
    return L * slots * max_len * per * itemsize


def decode_attention_work(B: int, H: int, KV: int, D: int, pos: int, itemsize: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) that one decode-attention call needs: each of B
    slots' query over keys 0…pos (two products of 2·D a key and head); the
    K and V rows up to pos read once, q read once, o written once."""
    keys = pos + 1
    return 4 * B * H * D * keys, (2 * B * keys * KV * D + 2 * B * H * D) * itemsize
