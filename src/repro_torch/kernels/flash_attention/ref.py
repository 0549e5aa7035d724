"""Plain PyTorch version of the flash_attention kernel.

Full-score softmax attention with causal / sliding-window masks, GQA
(query head h reads kv head h // (H // KV), as ``jnp.repeat`` maps it)
and tanh logit soft-capping: the function of the JAX oracle
``repro.kernels.flash_attention.ref.flash_attention_ref``. Scores are
accumulated in float32 from the inputs as they are (the kernel does the
same; the JAX oracle rounds a bf16 product to bf16 first, which lies
inside the bf16 tolerance); the normalised probabilities are cast to
the value type before the PV product, as in the oracle.
"""
from __future__ import annotations

import torch

from ..._device import warm_host_math

__all__ = ["NEG_INF", "flash_attention_ref"]

NEG_INF = -2.0e38


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q, k: (B, Sq, H, D), (B, Sk, KV, D); v: (B, Sk, KV, Dv) → (B, Sq, H, Dv),
    scaled by D^-0.5 (MLA: D = nope + rope = 192 against Dv = 128)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qg = q.reshape(B, Sq, KV, rep, D)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * (D ** -0.5)
    warm_host_math(s)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & ((qp - kp) < window)
    s = torch.where(m, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v)
    return out.reshape(B, Sq, H, v.shape[-1])
