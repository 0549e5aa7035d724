"""Plain PyTorch version of the decode_attention kernel.

One query token against a length-S KV cache with position masking
(``kp ≤ pos``, and ``pos − kp < window`` when a window is set), GQA and
tanh soft-capping: the function of the JAX oracle
``repro.kernels.decode_attention.ref.decode_attention_ref``. Scores
accumulate in float32 (as in the kernel); the normalised probabilities
are cast to the value type before the PV product, as in the oracle.
"""
from __future__ import annotations

import torch

from ..._device import warm_host_math

__all__ = ["NEG_INF", "decode_attention_ref"]

NEG_INF = -2.0e38


def decode_attention_ref(q, k, v, pos: int, *, window=0, softcap=0.0, scale=None):
    """q: (B, H, D); k, v: (B, S, KV, D); pos an int → (B, H, D), scores
    scaled by ``scale`` (default D^-0.5; the kernel's padded route runs a
    wider instance at the true width's scale)."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qg = q.reshape(B, KV, rep, D)
    s = torch.einsum("bgrd,bkgd->bgrk", qg.float(), k.float()) * (D ** -0.5 if scale is None else scale)
    warm_host_math(s)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    idx = torch.arange(S, device=q.device)
    valid = idx <= pos
    if window > 0:
        valid = valid & ((pos - idx) < window)
    s = torch.where(valid, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bgrk,bkgd->bgrd", p, v)
    return out.reshape(B, H, D)
