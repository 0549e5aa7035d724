"""Plain PyTorch versions of the cost_matrix kernels (paper §IV/§V).

Each takes exactly the packed inputs its CUDA kernel takes and repeats
its arithmetic in the same order, so on the card kernel and plain
version agree bit for bit; on the host the ops wrappers run these.

Job classes ride as an int8 (J,) column: 0 COMPUTE, 1 DATA, 2 BOTH.
"""
from __future__ import annotations

import torch

from ..._device import sqrt_rn

__all__ = [
    "CLASS_COMPUTE",
    "CLASS_DATA",
    "CLASS_BOTH",
    "cost_matrix_f32_ref",
    "cost_matrix_f64_ref",
    "cost_argmin_f64_ref",
]

CLASS_COMPUTE, CLASS_DATA, CLASS_BOTH = 0, 1, 2
DEAD_F32 = 3.0e38


def cost_matrix_f32_ref(jb, jw, wc, wd, rows, w_queue=1.0, w_work=1.0, w_load=1.0):
    """The TPU kernel's float32 plane: ``rows`` is (9, S) — cap, queue,
    work, load, bw, loss, rtt, alive, mss; net + wc·comp + wd·dtc with
    dead columns at 3e38."""
    cap, queue, work, load, bw, loss, rtt, alive, mss = rows
    mathis = mss / (rtt * torch.sqrt(torch.clamp_min(loss, 1e-12)))
    eff = torch.where(loss > 0.0, torch.minimum(bw, mathis), bw)
    net = (loss / bw) * 1.0e6
    comp_site = (w_queue * queue + w_work * work) / cap + w_load * load
    comp = comp_site[None, :] + jw[:, None] / cap[None, :]
    dtc = jb[:, None] / eff[None, :]
    cost = net[None, :] + wc[:, None] * comp + wd[:, None] * dtc
    return torch.where(alive[None, :] > 0.5, cost, DEAD_F32)


def _site_terms_f64(rows, w_queue, w_work, w_load):
    """Per-site (net, eff_bw, comp_site, cap) in ``repro.core.batch``'s
    ``cost_components``/``comp_site_column`` operation order; ``rows``
    is (8, S) in PACK_FIELDS order."""
    cap, queue, work, load, bw, loss, rtt, mss = rows
    net = (loss / bw) * 1.0e6
    mathis = mss / (rtt * sqrt_rn(loss))
    eff = torch.where(loss > 0.0, torch.minimum(bw, mathis), bw)
    comp_site = w_queue * queue / cap + w_work * work / cap + w_load * load
    return net, eff, comp_site, cap


def cost_matrix_f64_ref(
    bytes_, work, cls, rows, alive,
    w_queue=1.0, w_work=1.0, w_load=1.0, mask_dead=True,
):
    """Per-class float64 (J, S) plane with ``class_total``'s addition
    order — DATA dtc+net, COMPUTE comp+net, BOTH (net+comp)+dtc — dead
    columns +inf when ``mask_dead``."""
    net, eff, comp_site, cap = _site_terms_f64(rows, w_queue, w_work, w_load)
    dtc = bytes_[:, None] / eff[None, :]
    comp = comp_site[None, :] + work[:, None] / cap[None, :]
    c = cls[:, None]
    cost = torch.where(
        c == CLASS_DATA,
        dtc + net,
        torch.where(c == CLASS_COMPUTE, comp + net, (net + comp) + dtc),
    )
    if mask_dead:
        cost = cost.masked_fill(~alive[None, :], float("inf"))
    return cost


def cost_argmin_f64_ref(bytes_, work, cls, rows, alive, w_queue=1.0, w_work=1.0, w_load=1.0):
    """Per-row (first index of the minimum, its cost) over the
    dead-masked float64 plane; a NaN counts as the minimum."""
    cost = cost_matrix_f64_ref(bytes_, work, cls, rows, alive, w_queue, w_work, w_load)
    best = torch.argmin(cost, dim=1)
    return best, cost.gather(1, best[:, None])[:, 0]
