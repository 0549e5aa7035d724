"""Carry a simulation's inputs across from the reference package.

Each function reads the reference's objects by attribute only (it
imports nothing of the reference) and returns the port's own objects,
every float carried exactly: the simulator's counterpart of
``core.interop.state_from_reference``. A seeded workload built by the
reference's generators, its link table, topology and configuration
then drive ``repro_torch.sim.GridSim`` with the very same inputs.
"""
from __future__ import annotations

import itertools
import re
from dataclasses import fields

from ..core.costs import CostWeights, NetworkLink
from ..core.topology import GridTopology, Node, RootGrid, SubGrid
from .config import SimConfig
from .faults import FaultEvent, FaultPlan, PartitionWindow, TransportFaults
from .workloads import JobList, SimJob

__all__ = [
    "config_from_reference",
    "jobs_from_reference",
    "links_from_reference",
    "topology_from_reference",
]


def _carry(cls, obj, **override):
    """A ``cls`` built from ``obj``'s attributes of the same names."""
    kw = {f.name: getattr(obj, f.name) for f in fields(cls) if f.init}
    kw.update(override)
    return cls(**kw)


def jobs_from_reference(sim_jobs) -> JobList:
    """The port's ``SimJob``s equal to the given ones, in order
    (runtime bookkeeping fields included)."""
    return JobList(_carry(SimJob, j) for j in sim_jobs)


def links_from_reference(links) -> dict[tuple[str, str], NetworkLink]:
    """The port's link table: ``NetworkLink``s keyed by the same
    (from, to) pairs, in the same order."""
    return {pair: _carry(NetworkLink, link) for pair, link in links.items()}


def topology_from_reference(topo) -> GridTopology:
    """The port's ``GridTopology`` with the same RootGrids, SubGrids and
    nodes (uids, availability, the master/standby roles and the
    replicated node tables), and the same next uid."""
    out = GridTopology()
    nodes: dict[int, Node] = {}

    def node(n) -> Node:
        if id(n) not in nodes:
            nodes[id(n)] = _carry(Node, n)
        return nodes[id(n)]

    for site, root in topo.rootgrids.items():
        out.rootgrids[site] = RootGrid(
            site=root.site,
            master=node(root.master),
            subgrids={
                name: SubGrid(name=sg.name, nodes={k: node(v) for k, v in sg.nodes.items()})
                for name, sg in root.subgrids.items()
            },
            standby=None if root.standby is None else node(root.standby),
            node_table=dict(root.node_table),
        )
    # The next uid the reference's counter would hand out, read from its
    # repr ("count(7)") without drawing from it.
    out._uid = itertools.count(int(re.fullmatch(r"count\((\d+)\)", repr(topo._uid)).group(1)))
    return out


def _fault_plan(plan) -> FaultPlan:
    return FaultPlan(events=[_carry(FaultEvent, ev) for ev in plan.events])


def _transport(tf) -> TransportFaults:
    return _carry(TransportFaults, tf, partitions=tuple(
        _carry(PartitionWindow, w) for w in tf.partitions))


def config_from_reference(cfg) -> SimConfig:
    """The port's ``SimConfig`` with every field of ``cfg``: weights,
    topology, ``FaultPlan`` and ``TransportFaults`` carried across."""
    return _carry(
        SimConfig, cfg,
        quotas=None if cfg.quotas is None else dict(cfg.quotas),
        weights=_carry(CostWeights, cfg.weights),
        topology=None if cfg.topology is None else topology_from_reference(cfg.topology),
        fault_plan=None if cfg.fault_plan is None else _fault_plan(cfg.fault_plan),
        transport_faults=None if cfg.transport_faults is None else _transport(cfg.transport_faults),
    )
