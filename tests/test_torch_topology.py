"""§IX P2P topology, ported: ``repro_torch.core.topology`` is plain Python
carried over from the reference; the reference's own tests run against
the port, and the tier index (two-level placement's tiers) must agree
with the reference's on the same joins."""
import pytest

import repro.core as R
from repro_torch.core import GridTopology, Node


def test_first_peer_creates_rootgrid():
    topo = GridTopology()
    root = topo.join("cern", Node(name="n0", availability=0.9))
    assert root.master.name == "n0"
    assert "cern" in topo.rootgrids


def test_join_existing_rootgrid():
    topo = GridTopology()
    topo.join("cern", Node(name="n0", availability=0.9))
    root = topo.join("cern", Node(name="n1", availability=0.99))
    assert set(root.node_table) == {"n0", "n1"}


def test_standby_is_highest_availability():
    topo = GridTopology()
    root = topo.join("cern", Node(name="n0", availability=0.5))
    topo.join("cern", Node(name="n1", availability=0.99))
    topo.join("cern", Node(name="n2", availability=0.7))
    assert root.standby.name == "n1"


def test_master_failover_promotes_standby_with_table():
    topo = GridTopology()
    root = topo.join("cern", Node(name="n0", availability=0.5))
    topo.join("cern", Node(name="n1", availability=0.99))
    topo.join("cern", Node(name="n2", availability=0.7))
    assert topo.fail_site_master("cern")
    assert root.master.name == "n1"           # standby took over
    assert root.standby.name == "n2"          # new standby elected
    assert set(root.node_table) >= {"n1", "n2"}


def test_failover_without_standby_fails():
    topo = GridTopology()
    topo.join("lonely", Node(name="solo"))
    assert not topo.fail_site_master("lonely")


def test_peers_excludes_self():
    topo = GridTopology()
    for site in ("cern", "fnal", "ral"):
        topo.join(site, Node(name=f"{site}-n0"))
    assert set(topo.peers("cern")) == {"fnal", "ral"}


def test_small_site_joins_nearest_subgrid():
    topo = GridTopology()
    topo.join("cern", Node(name="n0"))
    root = topo.join("tiny", Node(name="t0"), nearest="cern")
    assert root.site == "cern"
    assert "t0" in root.node_table


def test_leave_updates_table():
    topo = GridTopology()
    topo.join("cern", Node(name="n0"))
    topo.join("cern", Node(name="n1"))
    topo.leave("cern", "n1")
    assert "n1" not in topo.rootgrids["cern"].node_table


def test_join_conflicting_nearest_raises():
    """A site with its own RootGrid routed at a *different* RootGrid
    via ``nearest`` is a conflict, not a silent ignore."""
    topo = GridTopology()
    topo.join("cern", Node(name="n0"))
    topo.join("fnal", Node(name="f0"))
    with pytest.raises(ValueError):
        topo.join("cern", Node(name="n1"), nearest="fnal")


def test_join_own_rootgrid_wins_over_redundant_nearest():
    """nearest naming the site's own RootGrid is redundant, not a
    conflict."""
    topo = GridTopology()
    topo.join("cern", Node(name="n0"))
    root = topo.join("cern", Node(name="n1"), nearest="cern")
    assert root.site == "cern"
    assert "n1" in root.node_table


def test_join_picks_least_loaded_subgrid():
    topo = GridTopology()
    root = topo.join("cern", Node(name="n0"))
    from repro_torch.core.topology import SubGrid

    root.register(SubGrid(name="cern/sg1"))
    # sg0 holds n0; the empty sg1 must win, then they alternate
    topo.join("cern", Node(name="n1"))
    assert "n1" in root.subgrids["cern/sg1"].nodes
    topo.join("cern", Node(name="n2"))
    sizes = sorted(len(sg.nodes) for sg in root.subgrids.values())
    assert sizes == [1, 2] or sizes == [2, 1]


def test_node_uids_deterministic_per_topology():
    """Two topologies built the same way assign the same uids — and
    never reuse one within a topology."""
    def build():
        topo = GridTopology()
        uids = []
        for i in range(6):
            n = Node(name=f"n{i}")
            topo.join(f"site{i % 2}", n)
            uids.append(n.uid)
        return uids

    a, b = build(), build()
    assert a == b
    assert len(set(a)) == len(a)
    assert 0 not in a            # the unset sentinel never survives join


def test_tier_index_mirrors_rootgrids():
    topo = GridTopology()
    topo.join("east", Node(name="s0"))
    topo.join("east", Node(name="s1"))
    topo.join("west", Node(name="s2"))
    names = ["s0", "s1", "s2", "loner"]
    assert topo.tier_of("s1") == "east"
    assert topo.tier_of("loner") == "loner"        # singleton fallback
    members = topo.tier_members(names)
    assert members["east"] == ["s0", "s1"]
    assert members["west"] == ["s2"]
    assert members["loner"] == ["loner"]


@pytest.mark.parametrize("seed", range(4))
def test_tier_index_matches_reference(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    names = [f"s{i:02d}" for i in range(30)]
    topos = []
    for mod in (R, None):
        topo = R.GridTopology() if mod else GridTopology()
        node = R.Node if mod else Node
        r = np.random.default_rng(seed)
        for n in names:
            if r.uniform() < 0.8:
                topo.join(f"root{int(r.integers(0, 5))}", node(name=n,
                          availability=float(r.uniform())))
        topos.append(topo)
    ref, port = topos
    probe = names + ["off-grid"]
    assert port.site_tiers(probe) == ref.site_tiers(probe)
    assert port.tier_members(probe) == ref.tier_members(probe)
    for site in ref.rootgrids:
        a, b = ref.rootgrids[site], port.rootgrids[site]
        assert (a.master.name, getattr(a.standby, "name", None), a.node_table) == \
            (b.master.name, getattr(b.standby, "name", None), b.node_table)
