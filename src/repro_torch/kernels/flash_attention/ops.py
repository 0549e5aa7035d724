"""Wrapper of the flash_attention CUDA kernel.

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
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import flash_attention_ref

__all__ = ["flash_attention", "launcher", "HEAD_DIMS", "PAIRS"]

_ENTRY = {torch.float32: "repro_flash_attention_f32", torch.bfloat16: "repro_flash_attention_bf16"}
HEAD_DIMS = (32, 64, 128, 256)   # the kernel's instances with v as wide as q and k
PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)   # every (D, Dv) instance


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """q: (B, Sq, H, D); k: (B, Sk, KV, D); v: (B, Sk, KV, Dv) → (B, Sq, H, Dv),
    scores scaled by D^-0.5.

    Query and key positions are 0…Sq−1 and 0…Sk−1. Every query row must
    see at least one key (Sk ≥ 1, and Sq ≤ Sk + window − 1 with a
    window); the TPU kernel's answer for a row with none is the mean of
    all values, which no model path asks for."""
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
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    if (D, Dv) not in PAIRS:
        raise ValueError(f"flash_attention: the kernel takes D, Dv in {PAIRS}, got {D}, {Dv}")
    if k.stride() != v.stride():
        raise ValueError("flash_attention: k and v must have the same strides")
    _build.check_rows("flash_attention", dict(q=q, k=k, v=v))
    o = torch.empty((B, Sq, H, Dv), dtype=dtype, device=dev)
    if B * Sq * H == 0:
        return o
    run = launcher(q, k, v, o, causal=causal, window=window, softcap=softcap)
    flash_attention.launches += 1
    flash_attention.by_pair[(D, Dv)] = flash_attention.by_pair.get((D, Dv), 0) + 1
    run()
    return o


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


flash_attention.launches = 0
flash_attention.by_pair = {}
