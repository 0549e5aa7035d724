"""Plain PyTorch version of the priority_requeue kernel (paper §X).

Same arithmetic, in the same order, as ``csrc/priority_requeue.cu`` and
``repro.core.priority.reprioritize``; the working type is the inputs'
(float32, or float64 for the host twin's parity)."""
from __future__ import annotations

import torch

__all__ = ["priority_requeue_ref"]


def priority_requeue_ref(n, q, t, quota_sum, proc_sum):
    """n, q, t: (L,) of one float type; Q, T scalars rounded to that
    type → (priorities (L,), queue index (L,) int32)."""
    Q = torch.tensor(quota_sum, dtype=n.dtype, device=n.device)
    T = torch.tensor(proc_sum, dtype=n.dtype, device=n.device)
    N = (q * T) / (Q * t)
    pr = torch.where(n <= N, (N - n) / N, (N - n) / n)
    band = (
        (pr < 0.5).to(torch.int32) + (pr < 0.0).to(torch.int32) + (pr < -0.5).to(torch.int32)
    )
    return pr, band
