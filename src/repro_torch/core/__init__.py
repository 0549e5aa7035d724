"""DIANA core, ported: the paper's scheduling algorithms (§IV–§X).

Public API re-exports: placement, quotas and bulk groups, §IX
migration, the RootGrid topology and two-level ("hier") placement, and
the decentralized P2P layer (peers, gossip exchange, delta-wire codec).
"""
from .costs import (
    CostWeights,
    JobDemand,
    NetworkLink,
    SiteState,
    computation_cost,
    data_transfer_cost,
    mathis_throughput,
    network_cost,
    total_cost,
    total_cost_matrix,
)
from . import priority  # submodule: priority.priority / priority.threshold …
from .priority import (
    NUM_QUEUES,
    queue_index,
    queue_index_vec,
    reprioritize,
    reprioritize_np,
    threshold,
)
from .queues import Job, MultilevelFeedbackQueues, is_congested
from .scheduler import DianaScheduler, JobClass, SiteDecision, classify
from .bulk import (
    BulkGroup,
    BulkScheduler,
    GroupPlacement,
    allocate_proportional,
    average_makespan,
    route_groups,
    stable_user_peer,
    submitting_peer,
)
from .migration import (
    MigrationDecision,
    PeerView,
    migrate_congested,
    select_peer,
    select_peers_batch,
)
from .topology import GridTopology, Node, RootGrid, SubGrid
from .batch import (
    PACK_FIELDS,
    BatchPlacement,
    JobPack,
    SitePack,
    TierPack,
    argmin_finite,
    batched_argmin,
    batched_cost_matrix,
    class_total,
    comp_site_column,
    cost_components,
    fused_argmin,
    hier_replay,
    hier_select,
    merge_packed_rows,
    replay_on_pack,
    replay_place,
)
from .engine import PlacementEngine
from .p2p import (
    ACK_WIRE_BYTES,
    QUANT_FIELDS,
    ExchangeStats,
    GossipExchange,
    PeerScheduler,
    SiteAdvert,
    decode_packet,
    encode_packet,
    single_peer,
)
from .interop import ReferenceState, state_from_reference

__all__ = [
    "CostWeights", "JobDemand", "NetworkLink", "SiteState",
    "computation_cost", "data_transfer_cost", "mathis_throughput",
    "network_cost", "total_cost", "total_cost_matrix",
    "NUM_QUEUES", "priority", "queue_index", "queue_index_vec",
    "reprioritize", "reprioritize_np", "threshold",
    # note: "priority" is the submodule (repro_torch.core.priority), not the fn
    "Job", "MultilevelFeedbackQueues", "is_congested",
    "DianaScheduler", "JobClass", "SiteDecision", "classify",
    "BulkGroup", "BulkScheduler", "GroupPlacement",
    "allocate_proportional", "average_makespan",
    "route_groups", "stable_user_peer", "submitting_peer",
    "MigrationDecision", "PeerView", "migrate_congested", "select_peer",
    "select_peers_batch",
    "GridTopology", "Node", "RootGrid", "SubGrid",
    "PACK_FIELDS", "BatchPlacement", "JobPack", "SitePack", "TierPack", "argmin_finite",
    "batched_argmin", "batched_cost_matrix", "class_total", "comp_site_column",
    "cost_components", "fused_argmin", "hier_replay", "hier_select",
    "merge_packed_rows", "replay_on_pack", "replay_place",
    "PlacementEngine",
    "ExchangeStats", "GossipExchange", "PeerScheduler", "SiteAdvert",
    "single_peer",
    "ACK_WIRE_BYTES", "QUANT_FIELDS", "decode_packet", "encode_packet",
    "ReferenceState", "state_from_reference",
]
