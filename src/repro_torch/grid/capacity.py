"""Pod capacity descriptors fed by the dry-run roofline artifacts.

The paper's PingER/MonALISA monitoring becomes: per-(arch × shape)
step costs read from dry-run artifacts (``arch``, ``shape``,
``step_time_lower_bound_s``), the same JSON fields the reference reads
(``repro.grid.capacity``). DIANA's computation-cost inputs are the
artifacts' roofline terms.

A pod's peak is counted in H100 cards here. Every decision
``DianaGridRuntime`` takes depends on ratios of ``flops`` (the bulk
split) or on the artifacts' step costs and ``chips``, never on the peak
itself, so the reference's decisions stay the same.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["PodCapacity", "capacity_from_artifact", "capacity_from_roofline",
           "PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "NVLINK_RX_BW"]

# NVIDIA H100 SXM data sheet, per card: dense BF16 on the tensor cores
# (no sparsity), HBM3 bandwidth, and NVLink 4 (900 GB/s to the other
# cards of the host, both directions together; NVLINK_RX_BW is the 450
# GB/s a card receives, the rate the dry run's collective term divides
# a rank's received bytes by).
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 900e9
NVLINK_RX_BW = 450e9


@dataclass
class PodCapacity:
    """A pod as a DIANA site: capacity in FLOP/s, link in bytes/s."""

    name: str
    chips: int = 256
    flops: float = 256 * PEAK_FLOPS
    dcn_bandwidth_Bps: float = 25e9       # pod-to-pod (DCN)
    dcn_loss_rate: float = 0.0
    dcn_rtt_s: float = 0.001
    # step-time lower bounds per (arch, shape) from the dry-run
    step_costs_s: dict = field(default_factory=dict)

    def step_cost(self, arch: str, shape: str) -> float:
        return self.step_costs_s.get((arch, shape), 0.0)


def capacity_from_artifact(name: str, artifact: dict, chips: int = 256) -> PodCapacity:
    cap = PodCapacity(name=name, chips=chips, flops=chips * PEAK_FLOPS)
    key = (artifact["arch"], artifact["shape"])
    cap.step_costs_s[key] = artifact["step_time_lower_bound_s"]
    return cap


def capacity_from_roofline(name: str, artifact_dir: str | Path,
                           chips: int = 256) -> PodCapacity:
    """Load every dry-run artifact under ``artifact_dir`` into one pod
    capacity table."""
    cap = PodCapacity(name=name, chips=chips, flops=chips * PEAK_FLOPS)
    for p in sorted(Path(artifact_dir).glob("*.json")):
        rec = json.loads(p.read_text())
        cap.step_costs_s[(rec["arch"], rec["shape"])] = rec["step_time_lower_bound_s"]
    return cap
