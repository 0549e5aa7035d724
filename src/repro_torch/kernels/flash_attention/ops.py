"""Wrappers of the flash_attention CUDA kernels, forward and backward.

Takes the model's layout, q (B, Sq, H, D) and k, v (B, Sk, KV, D), as the
reference wrapper ``repro.kernels.flash_attention.ops.flash_attention``
does; the kernel reads them through their strides, so nothing is
transposed. v may be narrower than q and k where the kernel has that
instance (``PAIRS``: MLA's 192-wide queries and keys against 128-wide
values); k and v then still share their strides, as two column ranges
of one buffer do. A tensor on the host goes to the plain version in
``ref.py``; a CUDA tensor launches the kernel (``csrc/flash_attention.cu``)
or raises. The wrapper counts its kernel launches in
``flash_attention.launches``, and per instance in
``flash_attention.by_pair[(D, Dv)]``. ``launcher`` builds the kernel's call on
checked CUDA tensors, for the wrapper and for timing it alone.

With grad enabled and an input that requires grad, ``flash_attention``
goes through ``FlashAttentionFn``: its forward is the same launch (or
plain version), it saves q, k, v and o, and its backward is
``flash_attention_bwd`` — on a CUDA tensor the backward kernel
(``csrc/flash_attention_bwd.cu``, which rebuilds the row statistics
itself: the forward keeps none), on a host tensor its plain version
``ref.flash_attention_bwd_ref``. A failed build or launch raises in
either direction. The backward counts its launches in
``flash_attention_bwd.launches`` and ``flash_attention_bwd.by_pair``;
``bwd_launcher`` is its timing handle.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_bwd", "FlashAttentionFn", "launcher", "bwd_launcher",
           "HEAD_DIMS", "PAIRS"]

_ENTRY = {torch.float32: "repro_flash_attention_f32", torch.bfloat16: "repro_flash_attention_bf16"}
_BWD_ENTRY = {torch.float32: "repro_flash_attention_bwd_f32", torch.bfloat16: "repro_flash_attention_bwd_bf16"}
HEAD_DIMS = (32, 64, 128, 256)   # the kernel's instances with v as wide as q and k
PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)   # every (D, Dv) instance


def _checked(q, k, v, window: int, softcap: float):
    """Validate a call's q, k, v and options; return (device, type)."""
    dev, dtype = _build.strided_device("flash_attention", dict(q=q, k=k, v=v), tuple(_ENTRY))
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention: q (B,Sq,H,D), k (B,Sk,KV,D) and v (B,Sk,KV,Dv); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != D or KV < 1 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "share B and D with H a multiple of KV")
    if window < 0 or softcap < 0:
        raise ValueError("flash_attention: window and softcap must be ≥ 0")
    if Sk < 1 or (window > 0 and Sq > Sk + window - 1):
        raise ValueError(f"flash_attention: a query row sees no key (Sq {Sq}, Sk {Sk}, window {window})")
    if dev.type == "cuda":
        if (D, Dv) not in PAIRS:
            raise ValueError(f"flash_attention: the kernel takes D, Dv in {PAIRS}, got {D}, {Dv}")
        if k.stride() != v.stride():
            raise ValueError("flash_attention: k and v must have the same strides")
        _build.check_rows("flash_attention", dict(q=q, k=k, v=v))
    return dev, dtype


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """q: (B, Sq, H, D); k: (B, Sk, KV, D); v: (B, Sk, KV, Dv) → (B, Sq, H, Dv),
    scores scaled by D^-0.5.

    Query and key positions are 0…Sq−1 and 0…Sk−1. Every query row must
    see at least one key (Sk ≥ 1, and Sq ≤ Sk + window − 1 with a
    window); the TPU kernel's answer for a row with none is the mean of
    all values, which no model path asks for. Differentiable: with grad
    enabled and an input that requires it, the call goes through
    ``FlashAttentionFn``."""
    _checked(q, k, v, window, softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, bool(causal), int(window), float(softcap))
    return _forward(q, k, v, causal, window, softcap)


def _forward(q, k, v, causal, window, softcap):
    """The forward on checked tensors: the plain version on the host, the
    kernel (counted) on the card."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    B, Sq, H, D = q.shape
    Dv = v.shape[3]
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if B * Sq * H == 0:
        return o
    run = launcher(q, k, v, o, causal=causal, window=window, softcap=softcap)
    flash_attention.launches += 1
    flash_attention.by_pair[(D, Dv)] = flash_attention.by_pair.get((D, Dv), 0) + 1
    run()
    return o


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its backward: the forward kernel (or plain
    version) one way, ``flash_attention_bwd`` the other."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o = _forward(q, k, v, causal, window, softcap)
        ctx.save_for_backward(q, k, v, o)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v, ...)`` = o at
    the output gradient do (B, Sq, H, Dv), in q's, k's and v's shapes and
    type: the backward kernel on the card, its plain version on the host."""
    dev, dtype = _checked(q, k, v, window, softcap)
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("o", o), ("do", do)):
        if not isinstance(t, torch.Tensor) or t.shape != (B, Sq, H, Dv) or t.device != dev:
            raise ValueError(f"flash_attention_bwd: {name} must be a ({B}, {Sq}, {H}, {Dv}) tensor on {dev}")
    if dev.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window, softcap=softcap)
    o, do = o.to(dtype).contiguous(), do.to(dtype).contiguous()
    dq = torch.empty((B, Sq, H, D), dtype=dtype, device=dev)
    dk = torch.empty((B, Sk, KV, D), dtype=dtype, device=dev)
    dv = torch.empty((B, Sk, KV, Dv), dtype=dtype, device=dev)
    if B * Sq * H == 0:
        return dq, dk.zero_(), dv.zero_()
    run = bwd_launcher(q, k, v, o, do, dq, dk, dv, causal=causal, window=window, softcap=softcap)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.by_pair[(D, Dv)] = flash_attention_bwd.by_pair.get((D, Dv), 0) + 1
    run()
    return dq, dk, dv


def launcher(q, k, v, o, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """The kernel's launch into ``o`` (B, Sq, H, Dv) as a closure, on CUDA
    tensors that ``flash_attention`` has checked."""
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    fn = getattr(_build.library(), _ENTRY[q.dtype])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, KV, Sq, Sk, D, Dv,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            int(bool(causal)), int(window), float(softcap), _build.stream_of(q.device))

    def run(_hold=(q, k, v, o)):
        _build.check(fn(*args), "flash_attention")
    return run


def bwd_launcher(q, k, v, o, do, dq, dk, dv, *, causal: bool = True, window: int = 0,
                 softcap: float = 0.0):
    """The backward kernels' launch (kernel A: lse, Δ and dq; kernel B: dk
    and dv) into dq, dk, dv as a closure, on CUDA tensors that
    ``flash_attention_bwd`` has checked (o, do contiguous)."""
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    fn = getattr(_build.library(), _BWD_ENTRY[q.dtype])
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), B, H, KV, Sq, Sk, D, Dv,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            int(bool(causal)), int(window), float(softcap), _build.stream_of(q.device))

    def run(_hold=(q, k, v, o, do, dq, dk, dv, lse, delta)):
        _build.check(fn(*args), "flash_attention_bwd")
    return run


flash_attention.launches = 0
flash_attention.by_pair = {}
flash_attention_bwd.launches = 0
flash_attention_bwd.by_pair = {}
