"""DIANA cost model (paper §IV).

    Network Cost       = Losses / Bandwidth
    Computation Cost   = W5·Qi/Pi + W6·Q/Pi + W7·SiteLoad
    Data Transfer Cost = (input + output + executable bytes) / eff. bandwidth
    Total Cost         = Network + Computation + DTC

Lossy links are capped by the Mathis TCP model (``mathis_throughput``).
The scalar terms are plain Python floats (host control plane);
``total_cost_matrix`` is the float32 (jobs × sites) plane in torch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch

from .._device import resolve_device

__all__ = [
    "NetworkLink",
    "SiteState",
    "CostWeights",
    "JobDemand",
    "mathis_throughput",
    "network_cost",
    "computation_cost",
    "data_transfer_cost",
    "total_cost",
    "total_cost_matrix",
]


@dataclass(frozen=True)
class NetworkLink:
    """A (directed) network path between two sites.

    bandwidth_Bps: nominal path bandwidth, bytes/second.
    loss_rate:     packet loss fraction in [0, 1).
    rtt_s:         round-trip time, seconds.
    mss_bytes:     TCP maximum segment size (Mathis model).
    """

    bandwidth_Bps: float
    loss_rate: float = 0.0
    rtt_s: float = 0.05
    mss_bytes: float = 1460.0

    def effective_bandwidth(self) -> float:
        """Nominal bandwidth, capped by the Mathis ceiling when lossy."""
        if self.loss_rate <= 0.0:
            return self.bandwidth_Bps
        return min(self.bandwidth_Bps, mathis_throughput(self))


@dataclass
class SiteState:
    """Dynamic state of a site as seen by the meta-scheduler (§IV/§V)."""

    name: str
    capacity: float                  # Pi — processors (grid) or FLOP/s (pod)
    queue_length: float = 0.0        # Qi — jobs waiting in the site queue
    waiting_work: float = 0.0        # Q  — aggregate queued work
    load: float = 0.0                # SiteLoad in [0, 1]
    alive: bool = True
    # Currently idle processors; None (unspecified) defaults to an idle
    # site. An explicit 0.0 means saturated and must stay 0.0.
    free_slots: Optional[float] = field(default=None)

    def __post_init__(self) -> None:
        if self.capacity <= 0:
            raise ValueError(f"site {self.name}: capacity must be > 0")
        if self.free_slots is None:
            self.free_slots = self.capacity


@dataclass(frozen=True)
class CostWeights:
    """W5/W6/W7 of the computation-cost formula (paper §IV)."""

    w_queue: float = 1.0     # W5 — weight of Qi/Pi
    w_work: float = 1.0      # W6 — weight of Q/Pi
    w_load: float = 1.0      # W7 — weight of SiteLoad


@dataclass(frozen=True)
class JobDemand:
    """Data/compute demands of one job (or one group treated as a job)."""

    compute_work: float = 1.0
    input_bytes: float = 0.0
    output_bytes: float = 0.0
    executable_bytes: float = 0.0

    @property
    def total_bytes(self) -> float:
        return self.input_bytes + self.output_bytes + self.executable_bytes


def mathis_throughput(link: NetworkLink) -> float:
    """Mathis et al. macroscopic TCP throughput: MSS/(RTT·sqrt(loss))."""
    if link.loss_rate <= 0.0:
        return link.bandwidth_Bps
    return link.mss_bytes / (link.rtt_s * math.sqrt(link.loss_rate))


def network_cost(link: NetworkLink) -> float:
    """§IV ``Losses / Bandwidth``, scaled to a canonical 1 MB probe."""
    return (link.loss_rate / link.bandwidth_Bps) * 1.0e6


def computation_cost(site: SiteState, weights: CostWeights = CostWeights()) -> float:
    """§IV: W5·Qi/Pi + W6·Q/Pi + W7·SiteLoad."""
    return (
        weights.w_queue * site.queue_length / site.capacity
        + weights.w_work * site.waiting_work / site.capacity
        + weights.w_load * site.load
    )


def data_transfer_cost(demand: JobDemand, link: NetworkLink) -> float:
    """§IV: input + output + executable transfer time (seconds)."""
    return demand.total_bytes / link.effective_bandwidth()


def total_cost(
    demand: JobDemand,
    site: SiteState,
    link: NetworkLink,
    weights: CostWeights = CostWeights(),
) -> float:
    """§IV: Total = Network + Computation + DTC."""
    return (
        network_cost(link)
        + computation_cost(site, weights)
        + data_transfer_cost(demand, link)
    )


def total_cost_matrix(
    job_bytes,        # (J,) total bytes to move per job
    job_work,         # (J,) compute work per job
    site_capacity,    # (S,)
    site_queue,       # (S,) Qi
    site_work,        # (S,) Q (aggregate queued work)
    site_load,        # (S,)
    link_bandwidth,   # (S,) nominal bytes/s toward each site
    link_loss,        # (S,)
    alive,            # (S,) bool
    weights: CostWeights = CostWeights(),
    link_rtt=0.05,
    mss_bytes: float = 1460.0,
    *,
    device=None,
) -> torch.Tensor:
    """The (J, S) float32 §IV total-cost plane; dead sites get +inf.

    ``job_work / capacity`` augments the W5/W6 queue terms with the
    job's own service time; lossy links are Mathis-capped like
    ``NetworkLink.effective_bandwidth``.
    """
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    jb = f32(job_bytes)[:, None]
    jw = f32(job_work)[:, None]
    cap = f32(site_capacity)[None, :]
    bw = f32(link_bandwidth)
    loss = f32(link_loss)
    rtt = torch.broadcast_to(f32(link_rtt), bw.shape)
    mathis = f32(mss_bytes) / (rtt * torch.sqrt(torch.clamp_min(loss, 1e-12)))
    eff_bw = torch.where(loss > 0.0, torch.minimum(bw, mathis), bw)
    net = (loss / bw)[None, :] * 1.0e6
    comp_site = (
        weights.w_queue * f32(site_queue) + weights.w_work * f32(site_work)
    )[None, :] / cap + weights.w_load * f32(site_load)[None, :]
    cost = net + (comp_site + jw / cap) + jb / eff_bw[None, :]
    dead = ~torch.as_tensor(alive, device=dev).bool()
    return cost.masked_fill(dead[None, :], float("inf"))
