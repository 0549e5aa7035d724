"""Wrapper of the priority_requeue CUDA kernel (paper §X).

A tensor on the host goes to the plain version in ``ref.py``; a CUDA
tensor launches the kernel (``csrc/priority_requeue.cu``) or raises. The
tail is masked in the kernel, so (L,) columns go in as they are. The
wrapper counts its kernel launches in ``priority_requeue.launches``.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import priority_requeue_ref

__all__ = ["priority_requeue"]

_ENTRY = {
    torch.float32: "repro_priority_requeue_f32",
    torch.float64: "repro_priority_requeue_f64",
}


def priority_requeue(n, q, t, quota_sum, proc_sum):
    """§X re-prioritization over L queued jobs → (pr (L,), band (L,) int32).

    ``n, q, t`` are (L,) tensors of one type, float32 (the TPU kernel's)
    or float64; ``quota_sum``/``proc_sum`` (Q, T) are rounded to it."""
    L = n.shape[0]
    dtype = n.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"priority_requeue: n must be float32 or float64, got {dtype}")
    dev = _build.launch_device(
        "priority_requeue",
        dict(n=n, q=q, t=t),
        dict(n=dtype, q=dtype, t=dtype),
        dict(n=(L,), q=(L,), t=(L,)),
    )
    if dev.type == "cpu":
        return priority_requeue_ref(n, q, t, quota_sum, proc_sum)
    pr = torch.empty(L, dtype=dtype, device=dev)
    band = torch.empty(L, dtype=torch.int32, device=dev)
    if L:
        # ctypes rounds a Python float to c_float like torch rounds Q, T.
        fn = getattr(_build.library(), _ENTRY[dtype])
        priority_requeue.launches += 1
        rc = fn(
            n.data_ptr(), q.data_ptr(), t.data_ptr(), float(quota_sum), float(proc_sum),
            pr.data_ptr(), band.data_ptr(), L, _build.stream_of(dev),
        )
        _build.check(rc, "priority_requeue")
    return pr, band


priority_requeue.launches = 0
