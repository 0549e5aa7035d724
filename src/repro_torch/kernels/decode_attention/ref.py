"""Plain PyTorch version of the decode_attention kernel.

One query token against a length-S KV cache with position masking
(``kp ≤ pos``, and ``pos − kp < window`` when a window is set), GQA and
tanh soft-capping: the function of the JAX oracle
``repro.kernels.decode_attention.ref.decode_attention_ref``. Scores
accumulate in float32 (as in the kernel); the normalised probabilities
are cast to the value type before the PV product, as in the oracle.

The key-range entry (``key0``, ``lse``) takes k and v as a range of a
longer cache whose key j sits at position key0 + j, and returns the
range's float32 output beside the natural log-sum-exp of its visible
scores, which is what ranks holding different ranges of one cache
combine (``models.attention.decode_attention_sharded``).
"""
from __future__ import annotations

import torch

from ..._device import warm_host_math

__all__ = ["NEG_INF", "decode_attention_ref"]

NEG_INF = -2.0e38


def decode_attention_ref(q, k, v, pos: int, *, window=0, softcap=0.0, scale=None, key0: int = 0, lse: bool = False):
    """q: (B, H, D); k, v: (B, S, KV, D); pos an int → (B, H, D), scores
    scaled by ``scale`` (default D^-0.5; the kernel's padded route runs a
    wider instance at the true width's scale). Key j sits at position
    key0 + j.

    With ``lse``: (out (B, H, D) float32, lse (B, H) float32). The
    unnormalised probabilities p = e^(s − max) are rounded to v's type and
    multiplied by v in float32, out = Σ p v / Σ p and lse = max + log Σ p;
    a head with no visible key gets out 0 and lse −inf (without ``lse``,
    out 0 too, as the kernel gives it)."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qg = q.reshape(B, KV, rep, D)
    s = torch.einsum("bgrd,bkgd->bgrk", qg.float(), k.float()) * (D ** -0.5 if scale is None else scale)
    warm_host_math(s)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    idx = key0 + torch.arange(S, device=q.device)
    valid = idx <= pos
    if window > 0:
        valid = valid & ((pos - idx) < window)
    if lse:
        s = s.masked_fill(~valid, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m)
        l = p.sum(dim=-1)
        acc = torch.einsum("bgrk,bkgd->bgrd", p.to(v.dtype).float(), v.float())
        out = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
        return out.reshape(B, H, D), (m[..., 0] + torch.log(l)).reshape(B, H)
    s = torch.where(valid, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1).masked_fill(~valid, 0.0).to(q.dtype)   # no visible key: 0
    out = torch.einsum("bgrk,bkgd->bgrd", p, v)
    return out.reshape(B, H, D)
