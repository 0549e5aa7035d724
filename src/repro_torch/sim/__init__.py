"""Discrete-event grid simulator (MONARC analogue, paper §XI), ported.

``GridSim`` runs on a device (the CUDA card unless ``device="cpu"``);
workloads, streaming, faults and configuration are the reference's
plain Python. The multi-scheduler ``P2PGridSim`` is a later slice
(ROADMAP.md queue A, step 9).
"""
from .config import SimConfig
from .faults import (
    FAULT_KINDS,
    FaultEvent,
    FaultPlan,
    PartitionWindow,
    TransportFaults,
)
from .grid import GridSim, SimResult, uniform_links
from .streaming import ArrivalSource, ChunkSource, StreamingQuantiles, StreamStats
from .workloads import (
    JobList,
    SimJob,
    bulk_burst,
    cms_case_study,
    diurnal_source,
    paper_grid_spec,
    poisson_source,
    poisson_stream,
    serving_trace_source,
)

__all__ = [
    "GridSim", "SimResult", "SimConfig", "uniform_links",
    "FaultEvent", "FaultPlan", "FAULT_KINDS",
    "PartitionWindow", "TransportFaults",
    "ArrivalSource", "ChunkSource", "StreamStats", "StreamingQuantiles",
    "SimJob", "JobList", "bulk_burst", "cms_case_study", "paper_grid_spec",
    "poisson_stream", "poisson_source", "diurnal_source",
    "serving_trace_source",
]
