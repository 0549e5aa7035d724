"""The plain reference: the configurations' forward pass in plain PyTorch.

Float32 with TF32 off (``precision="fp32"``), or every product's operands
rounded to float8 e4m3 first, with a scale a row of activations and a
column of weights (``precision="fp8"``): the control, the step below the
configurations' bfloat16. It imports nothing of the program. It reads
the weights the benchmark made, by the port's parameter names, and the
token ids of a batch (B lanes × L positions), and computes all positions
of all lanes at once, layer by layer:

  embedding   table rows times √d rounded to bf16 (the model's constant)
  norms       RMSNorm, eps 1e-6, scale stored as (scale − 1)
  rotary      theta ``rope_theta``, the two halves of a head rotated
  dense       GQA causal attention, scores scaled by D^-0.5; squared-ReLU
              or SwiGLU MLP
  MLA         queries from the rank-``q_lora_rank`` latent, keys and
              values from the rank-``kv_lora_rank`` latent and one rotary
              key for all heads, scores scaled by (dn + dr)^-0.5
  MoE         softmax router, the top k (lower expert first among
              equals) renormalised to sum to one; the engine's decode
              step is one dispatch over the B lanes of a position, so
              here too: each expert takes C = max(8, ⌊B·k·cf/E⌋) slots a
              position, filled choice by choice (all lanes' first choice,
              then their second, …), lanes in order, and a choice past C
              is dropped; then the shared experts
  head        the final norm, then the untied table: float32 logits

Attention is computed in blocks of lanes, the experts one at a time with
their weights widened to float32 as they are used, so that the whole
batch fits beside the bf16 weights.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["Reference"]

_F8_MAX = 448.0


def _round_f8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale along ``dim``'s slices (amax → 448)."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / _F8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    def __init__(self, weights: dict[str, torch.Tensor], cfg: dict, precision: str = "fp32", lane_block: int = 16):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.W, self.cfg, self.precision, self.lane_block = weights, cfg, precision, lane_block
        self.d = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.mla = bool(cfg.get("kv_lora_rank"))
        self.moe = bool(cfg.get("n_routed_experts"))
        self.eps = cfg["rms_norm_eps"]
        self.dropped = 0            # routed choices past their expert's capacity, over every call

    # -- pieces ------------------------------------------------------------------
    def w(self, name: str) -> torch.Tensor:
        return self.W[name].float()

    def lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., m) · w (m, n), w already float32."""
        if self.precision == "fp8":
            x, w = _round_f8(x, -1), _round_f8(w, 0)
        return x @ w

    def norm(self, x: torch.Tensor, scale_name: str) -> torch.Tensor:
        x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps)
        return x * (1.0 + self.w(scale_name))

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (b, L, [H,] D): the halves [x1, x2] rotated by pos·theta^(-i/(D/2))."""
        half = x.shape[-1] // 2
        freq = float(self.cfg["rope_theta"]) ** (-torch.arange(half, device=x.device, dtype=torch.float32) / half)
        ang = pos[:, None].float() * freq                          # (L, half)
        if x.dim() == 4:
            ang = ang[:, None, :]
        sin, cos = torch.sin(ang), torch.cos(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    @staticmethod
    def attend(q, k, v, scale: float) -> torch.Tensor:
        """Causal softmax attention: q (b, L, H, Dq), k (b, L, H, Dq), v (b, L, H, Dv) → (b, L, H, Dv)."""
        L = q.shape[1]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    def mlp(self, h: torch.Tensor, prefix: str, act: str) -> torch.Tensor:
        if act == "silu":
            a = F.silu(self.lin(h, self.w(f"{prefix}.w_gate"))) * self.lin(h, self.w(f"{prefix}.w_up"))
        else:
            a = torch.relu(self.lin(h, self.w(f"{prefix}.w_up"))).square()
        return self.lin(a, self.w(f"{prefix}.w_down"))

    # -- attention layers, one block of lanes --------------------------------------
    def gqa(self, h: torch.Tensor, p: str, pos: torch.Tensor) -> torch.Tensor:
        cfg, H = self.cfg, self.H
        KV = cfg["num_key_value_heads"]
        D = cfg.get("head_dim") or self.d // H
        b, L, d = h.shape
        q = self.rope(self.lin(h, self.w(f"{p}.wq").reshape(d, H * D)).view(b, L, H, D), pos)
        k = self.rope(self.lin(h, self.w(f"{p}.wk").reshape(d, KV * D)).view(b, L, KV, D), pos)
        v = self.lin(h, self.w(f"{p}.wv").reshape(d, KV * D)).view(b, L, KV, D)
        rep = H // KV
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        o = self.attend(q, k, v, D ** -0.5)
        return self.lin(o.reshape(b, L, H * D), self.w(f"{p}.wo").reshape(H * D, d))

    def mla_attn(self, h: torch.Tensor, p: str, pos: torch.Tensor) -> torch.Tensor:
        cfg, H = self.cfg, self.H
        rq, rkv = cfg["q_lora_rank"], cfg["kv_lora_rank"]
        dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
        b, L, d = h.shape
        if rq:
            cq = self.norm(self.lin(h, self.w(f"{p}.wq_a")), f"{p}.q_norm")
            q = self.lin(cq, self.w(f"{p}.wq_b").reshape(rq, H * (dn + dr)))
        else:
            q = self.lin(h, self.w(f"{p}.wq").reshape(d, H * (dn + dr)))
        q = q.view(b, L, H, dn + dr)
        q = torch.cat([q[..., :dn], self.rope(q[..., dn:], pos)], dim=-1)
        kv_a = self.lin(h, self.w(f"{p}.wkv_a"))
        c = self.norm(kv_a[..., :rkv], f"{p}.kv_norm")
        kr = self.rope(kv_a[..., rkv:], pos)                        # (b, L, dr): one key for every head
        kv = self.lin(c, self.w(f"{p}.wkv_b").reshape(rkv, H * (dn + dv))).view(b, L, H, dn + dv)
        k = torch.cat([kv[..., :dn], kr[:, :, None, :].expand(b, L, H, dr)], dim=-1)
        o = self.attend(q, k, kv[..., dn:], (dn + dr) ** -0.5)
        return self.lin(o.reshape(b, L, H * dv), self.w(f"{p}.wo").reshape(H * dv, d))

    # -- the routed experts, all lanes ------------------------------------------------
    def experts(self, h: torch.Tensor, p: str) -> torch.Tensor:
        cfg = self.cfg
        B, L, d = h.shape
        E, K = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
        C = max(8, int(B * K * cfg["capacity_factor"] / E))
        probs = torch.softmax(self.lin(h, self.w(f"{p}.moe.router")), dim=-1)          # (B, L, E)
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[..., :K], idx[..., :K]
        gates = gates / gates.sum(-1, keepdim=True)
        # each (lane, position, choice)'s slot in its expert at that position
        counts = torch.zeros(L, E, dtype=torch.int64, device=h.device)
        slot = torch.empty_like(idx)
        for k in range(K):
            oh = F.one_hot(idx[..., k], E)                                               # (B, L, E)
            slot[..., k] = ((torch.cumsum(oh, dim=0) - oh + counts) * oh).sum(-1)
            counts += oh.sum(0)
        keep = slot < C
        self.dropped += int((~keep).sum())
        y = torch.zeros_like(h)
        for e in range(E):
            sel = (idx == e) & keep                                                      # (B, L, K)
            lanes, poss, ks = torch.nonzero(sel, as_tuple=True)
            if lanes.numel() == 0:
                continue
            x = h[lanes, poss]
            a = F.silu(self.lin(x, self.W[f"{p}.moe.w_gate"][e].float())) * self.lin(x, self.W[f"{p}.moe.w_up"][e].float())
            out = self.lin(a, self.W[f"{p}.moe.w_down"][e].float())
            y.index_put_((lanes, poss), gates[lanes, poss, ks, None] * out, accumulate=True)
        return y + self.mlp(h, f"{p}.moe.shared", "silu")

    # -- the model ------------------------------------------------------------------
    def layers(self) -> list[tuple[str, str]]:
        """(parameter prefix, feed-forward kind) of each layer, in order."""
        L = self.cfg["num_hidden_layers"]
        if not self.moe:
            return [(f"blocks.{i}", "mlp") for i in range(L)]
        k = self.cfg["first_k_dense_replace"]
        return [(f"dense_blocks.{i}", "mlp") for i in range(k)] + [(f"moe_blocks.{i}", "moe") for i in range(L - k)]

    @torch.no_grad()
    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, L) → the final normed hidden states (B, L, d), float32."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        B, L = tokens.shape
        pos = torch.arange(L, device=tokens.device)
        scale = float(torch.tensor(math.sqrt(self.d), dtype=torch.bfloat16))
        x = self.W["embed"][tokens].float() * scale
        act = self.cfg["hidden_act"]
        for p, kind in self.layers():
            attn = self.mla_attn if self.mla else self.gqa
            a_prefix = f"{p}.attn"
            for s in range(0, B, self.lane_block):
                blk = x[s:s + self.lane_block]
                blk += attn(self.norm(blk, f"{p}.ln1"), a_prefix, pos)
            h = self.norm(x, f"{p}.ln2")
            x += self.experts(h, p) if kind == "moe" else self.mlp(h, f"{p}.mlp", act)
            del h
        return self.norm(x, "final_norm")

    def logits(self, h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """h (..., d) normed → float32 logits (..., V); ``table`` from ``head_table``."""
        if self.precision == "fp8":
            h = _round_f8(h, -1)
        return h @ table.t()

    def head_table(self) -> torch.Tensor:
        """The head's (V, d) table in float32 (in the control, each row rounded to float8 once)."""
        name = "embed" if self.cfg.get("tie_word_embeddings") else "unembed"
        if self.precision != "fp8":
            return self.w(name)
        t = self.W[name].to(torch.float32, copy=True)
        for s in range(0, t.shape[0], 16384):
            t[s:s + 16384] = _round_f8(t[s:s + 16384], -1)
        return t
