"""Plain PyTorch versions of the flash_attention kernel and its backward.

Full-score softmax attention with causal / sliding-window masks, GQA
(query head h reads kv head h // (H // KV), as ``jnp.repeat`` maps it)
and tanh logit soft-capping: the function of the JAX oracle
``repro.kernels.flash_attention.ref.flash_attention_ref``. Scores are
accumulated in float32 from the inputs as they are (the kernel does the
same; the JAX oracle rounds a bf16 product to bf16 first, which lies
inside the bf16 tolerance); the normalised probabilities are cast to
the value type before the PV product, as in the oracle.

``flash_attention_bwd_ref`` is the plain version of the backward kernel
(``csrc/flash_attention_bwd.cu``): the gradients of that function with
respect to q, k and v, from its output o and the output's gradient dO,
all in float32 (the bf16 forward's rounding of P before the PV product
is not differentiated, as the kernel does not) and returned in the
inputs' types.

Both take ``scale``, the factor of q·kᵀ (default D^-0.5 of q's width):
the kernels' padded route runs a wider instance on zero-padded q, k and
v at the true width's scale. ``flash_attention_ref(..., return_lse=True)``
also returns the row log-sum-exp (B, H, Sq) of the masked, capped
float32 scores, which the forward kernel writes for the backward;
``flash_attention_bwd_ref(..., lse=...)`` then takes P = exp(t − lse)
from it instead of a softmax.
"""
from __future__ import annotations

import torch

from ..._device import warm_host_math

__all__ = ["NEG_INF", "flash_attention_ref", "flash_attention_bwd_ref"]

NEG_INF = -2.0e38


def _mask(Sq: int, Sk: int, causal: bool, window: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: key kp visible from query qp."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & ((qp - kp) < window)
    return m


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None, return_lse=False):
    """q, k: (B, Sq, H, D), (B, Sk, KV, D); v: (B, Sk, KV, Dv) → (B, Sq, H, Dv),
    scores scaled by ``scale`` (default D^-0.5; MLA: D = nope + rope = 192
    against Dv = 128); with ``return_lse`` also the row log-sum-exp
    (B, H, Sq), float32."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qg = q.reshape(B, Sq, KV, rep, D)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * (D ** -0.5 if scale is None else scale)
    warm_host_math(s)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    m = _mask(Sq, Sk, causal, window, q.device)
    s = torch.where(m, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v).reshape(B, Sq, H, v.shape[-1])
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return out


def flash_attention_bwd_ref(q, k, v, o, do, *, causal=True, window=0, softcap=0.0, scale=None, lse=None):
    """q (B, Sq, H, D), k (B, Sk, KV, D), v (B, Sk, KV, Dv), the forward's
    output o and its gradient do (B, Sq, H, Dv) → (dq, dk, dv) in the
    shapes and types of q, k and v: s = q·kᵀ·scale (default D^-0.5),
    t = cap·tanh(s/cap), P = softmax(mask(t)) (exp(mask(t) − lse) given the
    forward's lse (B, H, Sq)), Δ = Σ do·o, dS = P∘(do·vᵀ − Δ)∘(1 − (t/cap)²);
    dq = dS·k·scale, dk = dSᵀ·q·scale and dv = Pᵀ·do, dk and dv summed
    over the query heads of each kv head."""
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = H // KV
    scale = D ** -0.5 if scale is None else scale
    qf = q.float().reshape(B, Sq, KV, rep, D)
    dof = do.float().reshape(B, Sq, KV, rep, Dv)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kf) * scale
    warm_host_math(s)
    u = None
    if softcap > 0:
        u = torch.tanh(s / softcap)
        s = softcap * u
    m = _mask(Sq, Sk, causal, window, q.device)
    s = torch.where(m, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    if lse is None:
        p = torch.softmax(s, dim=-1)
    else:
        p = torch.exp(s - lse.float().reshape(B, KV, rep, Sq, 1))
    del s
    delta = (dof * o.float().reshape(B, Sq, KV, rep, Dv)).sum(-1).permute(0, 2, 3, 1)   # (B, KV, rep, Sq)
    ds = torch.einsum("bqgrd,bkgd->bgrqk", dof, vf).sub_(delta[..., None]).mul_(p)
    if u is not None:
        ds.mul_(1.0 - u * u)
    del u
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, kf).reshape(B, Sq, H, D) * scale
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qf) * scale
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
