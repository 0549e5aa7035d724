"""P2P meta-scheduler topology (paper §IX, Fig 5).

Nodes are grouped into SubGrids; each site has one RootGrid (the master
node) and one or more SubGrids. Meta-schedulers live at RootGrids and
talk RootGrid↔RootGrid (P2P) — never all-to-all at node level. Each
RootGrid keeps a real-time table of its SubGrid nodes and replicates it
to a standby node, which promotes itself if the RootGrid crashes.

Join protocol: the first peer creates the RootGrid; later peers join
the nearest SubGrid (or create their own if they bring a whole site).
Plain Python, carried over from the reference unchanged: the port's
two-level placement (``TierPack``, ``GridSim(placement="hier")``) reads
its tiers from here.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional, Sequence

__all__ = ["Node", "SubGrid", "RootGrid", "GridTopology"]


@dataclass
class Node:
    name: str
    capacity: float = 1.0
    availability: float = 1.0        # §IX: root should maximize availability
    alive: bool = True
    # 0 = "not yet joined": GridTopology.join assigns the next uid from
    # its own per-topology counter, so standby-election tie-breaks
    # (availability, -uid) depend only on this topology's join order —
    # never on how many Nodes other tests/topologies created first.
    uid: int = 0


@dataclass
class SubGrid:
    name: str
    nodes: dict[str, Node] = field(default_factory=dict)

    def add(self, node: Node) -> None:
        self.nodes[node.name] = node

    def remove(self, name: str) -> Optional[Node]:
        return self.nodes.pop(name, None)

    @property
    def capacity(self) -> float:
        return sum(n.capacity for n in self.nodes.values() if n.alive)


@dataclass
class RootGrid:
    """Master node of a site; hosts the meta-scheduler (§IX)."""

    site: str
    master: Node
    subgrids: dict[str, SubGrid] = field(default_factory=dict)
    standby: Optional[Node] = None
    # The replicated real-time node table (master → standby).
    node_table: dict[str, bool] = field(default_factory=dict)

    def register(self, subgrid: SubGrid) -> None:
        self.subgrids[subgrid.name] = subgrid
        self._sync_table()

    def _sync_table(self) -> None:
        self.node_table = {
            n.name: n.alive
            for sg in self.subgrids.values()
            for n in sg.nodes.values()
        }

    def node_joined(self, subgrid_name: str, node: Node) -> None:
        self.subgrids[subgrid_name].add(node)
        self._sync_table()
        self._elect_standby()

    def node_left(self, subgrid_name: str, name: str) -> None:
        self.subgrids[subgrid_name].remove(name)
        self._sync_table()
        self._elect_standby()

    def _elect_standby(self) -> None:
        """Standby = highest-availability node that isn't the master."""
        candidates = [
            n
            for sg in self.subgrids.values()
            for n in sg.nodes.values()
            if n.alive and n.name != self.master.name
        ]
        self.standby = max(candidates, key=lambda n: (n.availability, -n.uid), default=None)

    def fail_master(self) -> bool:
        """§IX: standby takes over with the replicated table."""
        self.master.alive = False
        if self.standby is None:
            return False
        self.master = self.standby
        self._elect_standby()
        self._sync_table()
        return True


class GridTopology:
    """The VO-wide view: RootGrids discoverable P2P (Fig 5)."""

    def __init__(self) -> None:
        self.rootgrids: dict[str, RootGrid] = {}
        self._uid = itertools.count(1)

    @staticmethod
    def _least_loaded_subgrid(root: RootGrid) -> SubGrid:
        """Deterministic SubGrid pick: fewest nodes, name tie-break."""
        return min(root.subgrids.values(), key=lambda sg: (len(sg.nodes), sg.name))

    def join(self, site: str, node: Node, nearest: Optional[str] = None) -> RootGrid:
        """§IX join protocol.

        If the site has no RootGrid yet, this peer creates it (and its
        first SubGrid). Small sites may instead join an existing
        SubGrid at ``nearest``. A ``site`` that already has its own
        RootGrid always routes there; naming a *different* existing
        RootGrid as ``nearest`` is a conflict and raises. Within the
        chosen RootGrid the node lands in the least-loaded SubGrid
        (fewest nodes, name tie-break), not an arbitrary first one.
        """
        if node.uid == 0:
            node.uid = next(self._uid)
        target: Optional[str] = None
        if site in self.rootgrids:
            if nearest is not None and nearest != site and nearest in self.rootgrids:
                raise ValueError(
                    f"join: site {site!r} already has its own RootGrid; "
                    f"nearest={nearest!r} names a different one"
                )
            target = site
        elif nearest is not None and nearest in self.rootgrids:
            target = nearest
        if target is None:
            root = RootGrid(site=site, master=node)
            sg = SubGrid(name=f"{site}/sg0")
            sg.add(node)
            root.register(sg)
            root._elect_standby()
            self.rootgrids[site] = root
            return root
        root = self.rootgrids[target]
        sg = self._least_loaded_subgrid(root)
        root.node_joined(sg.name, node)
        return root

    def leave(self, site: str, name: str) -> None:
        root = self.rootgrids.get(site)
        if root is None:
            return
        for sg in root.subgrids.values():
            if name in sg.nodes:
                root.node_left(sg.name, name)
                return

    def peers(self, site: str) -> list[str]:
        """RootGrid↔RootGrid peer list (excludes self)."""
        return [s for s in self.rootgrids if s != site]

    # -- tier index (two-level placement) -------------------------------
    #
    # A "tier" is a RootGrid: scheduler sites that are RootGrid sites map
    # to themselves, sites that joined another RootGrid (as nodes) map to
    # that RootGrid's site, and sites unknown to the topology form
    # singleton tiers named after themselves. Mirrors the grouping
    # ``p2p.PeerScheduler._rootgrid_of`` uses for gossip fan-out, so the
    # placement hierarchy and the gossip hierarchy agree.

    def tier_of(self, site: str) -> str:
        """Tier label (RootGrid site) for a scheduler site name."""
        if site in self.rootgrids:
            return site
        for root_site, root in self.rootgrids.items():
            if site in root.node_table:
                return root_site
        return site

    def site_tiers(self, names: Sequence[str]) -> dict[str, str]:
        """Map each site name to its tier label."""
        return {name: self.tier_of(name) for name in names}

    def tier_members(self, names: Sequence[str]) -> dict[str, list[str]]:
        """Tier label → member site names (order preserved from ``names``)."""
        members: dict[str, list[str]] = {}
        for name in names:
            members.setdefault(self.tier_of(name), []).append(name)
        return members

    def fail_site_master(self, site: str) -> bool:
        return self.rootgrids[site].fail_master()
