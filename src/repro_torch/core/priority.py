"""Quota-economy priority calculation (paper §X).

For a job from user ``u`` requiring ``t`` processors:

    N  = (q · T) / (Q · t)          — dynamic per-job threshold
    Pr = (N − n) / N   if n ≤ N     — favoured        (in [0, 1))
         (N − n) / n   otherwise    — over-threshold  (in (−1, 0))

n = the user's jobs in all queues (incl. the new one), q = the user's
quota, Q = sum of quotas of all *distinct* users with queued jobs, T =
processors required by all queued jobs, t = this job's requirement.
Every arrival re-prioritizes every queued job; service does not.

Queue bands: Q1: 0.5 ≤ p, Q2: 0 ≤ p < 0.5, Q3: −0.5 ≤ p < 0, Q4: p < −0.5.

``reprioritize`` is the float32 vector form, on the card through the
``priority_requeue`` kernel; ``reprioritize_np`` is the host float64
twin the queue manager calls on every arrival.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.priority_requeue.ops import priority_requeue

__all__ = [
    "threshold",
    "priority",
    "queue_index",
    "queue_index_vec",
    "reprioritize",
    "reprioritize_np",
    "NUM_QUEUES",
    "QUEUE_BOUNDS",
]

NUM_QUEUES = 4
# Lower bounds of Q1..Q4, descending priority.
QUEUE_BOUNDS = (0.5, 0.0, -0.5, -1.0)


def threshold(q: float, Q: float, t: float, T: float) -> float:
    """N = (q·T)/(Q·t) — paper equation (VI)."""
    if q <= 0 or Q <= 0 or t <= 0 or T <= 0:
        raise ValueError("quota/processor quantities must be positive")
    return (q * T) / (Q * t)


def priority(n: float, N: float) -> float:
    """Pr(n) per paper §X; always in (−1, 1)."""
    if n <= 0:
        raise ValueError("n counts the user's queued jobs incl. the new one")
    if n <= N:
        return (N - n) / N
    return (N - n) / n


def queue_index(p: float) -> int:
    """Map a priority to its multilevel queue: 0→Q1 … 3→Q4."""
    if p >= 0.5:
        return 0
    if p >= 0.0:
        return 1
    if p >= -0.5:
        return 2
    return 3


def queue_index_vec(p: torch.Tensor) -> torch.Tensor:
    """Vectorized queue bucketing: 0→Q1 … 3→Q4 (int32)."""
    return (p < 0.5).to(torch.int32) + (p < 0.0).to(torch.int32) + (p < -0.5).to(torch.int32)


def reprioritize(
    user_job_counts,     # (L,) n per queued job (its user's total)
    user_quota,          # (L,) q per queued job
    job_procs,           # (L,) t per queued job
    quota_sum: float,    # Q — sum over *distinct* users
    proc_sum: float,     # T — sum of t over all queued jobs
    *,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Float32 §X re-prioritization of all L queued jobs on ``device``
    (the card by default) → (priorities (L,), queue indices (L,))."""
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    return priority_requeue(
        f32(user_job_counts), f32(user_quota), f32(job_procs), quota_sum, proc_sum
    )


def reprioritize_np(
    user_job_counts: np.ndarray,
    user_quota: np.ndarray,
    job_procs: np.ndarray,
    quota_sum: float,
    proc_sum: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Host float64 twin of ``reprioritize`` for the control plane (the
    queue manager calls it once per arrival; no device dispatch)."""
    n = np.asarray(user_job_counts, np.float64)
    q = np.asarray(user_quota, np.float64)
    t = np.asarray(job_procs, np.float64)
    N = (q * proc_sum) / (quota_sum * t)
    pr = np.where(n <= N, (N - n) / N, (N - n) / n)
    qidx = (pr < 0.5).astype(np.int32) + (pr < 0.0) + (pr < -0.5)
    return pr, qidx.astype(np.int32)


def littles_law_queue_length(arrival_rate: float, wait_time: float) -> float:
    """Little's formula N = R·W (paper §VII)."""
    return arrival_rate * wait_time
