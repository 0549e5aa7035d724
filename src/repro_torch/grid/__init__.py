"""Grid binding: DIANA scheduling over a fleet of GPU pods (the port of
``repro.grid``; a pod's capacity is counted in H100 cards)."""
from .capacity import PodCapacity, capacity_from_artifact, capacity_from_roofline
from .runtime import DianaGridRuntime, PodHandle, WorkItem

__all__ = [
    "PodCapacity", "capacity_from_artifact", "capacity_from_roofline",
    "DianaGridRuntime", "PodHandle", "WorkItem",
]
