"""The port's pod runtime (``repro_torch.grid``) against the reference's
(``repro.grid``), on the host.

Every scenario of ``tests/substrate/test_serving_grid.py::TestGridRuntime``
and ``examples/grid_schedule.py``'s scenario runs through both packages:
each item's pod, the moved list, the orphans and the ``placement_cost``
values must be equal, and the example's decisions equal to the literals
pinned from the reference in ``repro_torch.grid.example`` (which
``chip_smoke.py`` also reads). A pod's peak is counted in H100 cards in
the port and in TPU v5e chips in the reference; every pod built here
takes its package's own peak, so the ratios the bulk split reads are
the same.
"""
import json
import re
from pathlib import Path

import pytest

import repro.grid as R
import repro.grid.capacity as R_cap
import repro_torch.grid as T
import repro_torch.grid.capacity as T_cap
from repro_torch.grid.example import PINNED, run_example

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"reference": (R, R_cap), "port": (T, T_cap)}


def _pods(G, cap):
    return [
        G.PodCapacity(name="p0", chips=256),
        G.PodCapacity(name="p1", chips=256),
        G.PodCapacity(name="p2", chips=128, flops=128 * cap.PEAK_FLOPS),
    ]


def _where(items):
    return [(it.pod, it.migrated, it.group_id is not None) for it in items]


def _costs(grid, item):
    return {p: grid.placement_cost(item, p) for p in grid.pods}


def single_placement(G, cap):
    grid = G.DianaGridRuntime(_pods(G, cap))
    item = G.WorkItem(user="u", arch="a", shape="train_4k", data_bytes=500e9, resident_pod="p1")
    before = _costs(grid, item)
    pod = grid.schedule(item)
    assert pod == "p1"                       # no transfer cost at home
    return dict(pod=pod, costs=before, after=_costs(grid, item))


def bulk_split(G, cap):
    grid = G.DianaGridRuntime(_pods(G, cap))
    items = [G.WorkItem(user="u", arch="a", shape="s") for _ in range(10)]
    placed = grid.schedule_bulk(items, division_factor=3)
    assert sum(len(v) for v in placed.values()) == 10
    assert len(placed["p2"]) <= len(placed["p0"])     # smaller pod, fewer jobs
    one = [G.WorkItem(user="u", arch="a", shape="s", resident_pod="p2", data_bytes=1e9)
           for _ in range(3)]
    whole = grid.schedule_bulk(one)
    return dict(split={p: [items.index(i) for i in v] for p, v in placed.items()},
                whole={p: len(v) for p, v in whole.items()}, items=_where(items + one),
                costs=_costs(grid, one[0]),
                queued={p: h.queued_seconds() for p, h in grid.pods.items()})


def straggler_migration(G, cap):
    grid = G.DianaGridRuntime(_pods(G, cap), quotas={"u": 10.0, "v": 1000.0})
    items = [G.WorkItem(user="u", arch="a", shape="s") for _ in range(6)]
    for i, it in enumerate(items):
        grid.pods["p2"].enqueue(it, now=float(i))
    items.append(G.WorkItem(user="v", arch="a", shape="s"))
    grid.pods["p2"].enqueue(items[-1], now=6.0)
    grid.set_degraded("p2", 0.3)
    costs = _costs(grid, items[0])
    moved = grid.mitigate_stragglers()
    assert moved, "degraded pod should shed queued work"
    assert all(t in ("p0", "p1") for _, t in moved)
    assert all(it.migrated for it, _ in moved)
    nxt = grid.pods["p0"].dequeue_next(now=7.0)
    return dict(moved=[(items.index(it), t) for it, t in moved], items=_where(items), costs=costs,
                next=items.index(nxt), effective={p: h.effective_flops() / cap.PEAK_FLOPS
                                                  for p, h in grid.pods.items()})


def pod_failure(G, cap):
    grid = G.DianaGridRuntime(_pods(G, cap))
    items = [G.WorkItem(user="u", arch="a", shape="s") for _ in range(4)]
    for it in items:
        grid.pods["p1"].enqueue(it)
    orphans = grid.pod_failed("p1")
    assert len(orphans) == 4
    assert all(o.pod in ("p0", "p2") for o in orphans)
    nxt = G.WorkItem(user="u", arch="a", shape="s")
    costs = _costs(grid, nxt)
    assert grid.schedule(nxt) != "p1"         # dead pod never selected again
    return dict(orphans=[(items.index(o), o.pod) for o in orphans], next=nxt.pod, costs=costs,
                masters={n: rg.master.name if rg.master else None
                         for n, rg in grid.topology.rootgrids.items()})


def elastic_join(G, cap):
    grid = G.DianaGridRuntime(_pods(G, cap))
    grid.pod_joined(G.PodCapacity(name="p3", chips=512, flops=512 * cap.PEAK_FLOPS))
    for name in ("p0", "p1", "p2"):
        for _ in range(8):
            grid.pods[name].enqueue(G.WorkItem(user="u", arch="a", shape="s"))
    item = G.WorkItem(user="u", arch="a", shape="s")
    costs = _costs(grid, item)
    assert grid.schedule(item) == "p3"       # heavily loaded pods → new big pod wins
    return dict(costs=costs, pod=item.pod, queues={p: len(h.queue) for p, h in grid.pods.items()})


SCENARIOS = [single_placement, bulk_split, straggler_migration, pod_failure, elastic_join]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_runtime_scenario_equals_the_reference(scenario):
    assert scenario(*PACKAGES["port"]) == scenario(*PACKAGES["reference"])


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_example_scenario_equals_the_pinned_decisions(package):
    assert run_example(PACKAGES[package][0]) == PINNED


def test_roofline_artifacts_are_read_as_the_reference_reads_them(tmp_path):
    recs = [dict(arch="gemma3-12b", shape="train_4k", step_time_lower_bound_s=0.75),
            dict(arch="gemma3-12b", shape="decode_32k", step_time_lower_bound_s=0.0125),
            dict(arch="deepseek-v2-236b", shape="train_4k", step_time_lower_bound_s=6.5,
                 extra="ignored")]
    for i, r in enumerate(recs):
        (tmp_path / f"a{i}.json").write_text(json.dumps(r))
    (tmp_path / "notes.txt").write_text("not an artifact")
    caps = {}
    for name, (G, cap) in PACKAGES.items():
        pod = G.capacity_from_roofline("pod-x", tmp_path, chips=64)
        one = G.capacity_from_artifact("pod-y", recs[2], chips=32)
        assert pod.flops == 64 * cap.PEAK_FLOPS and one.flops == 32 * cap.PEAK_FLOPS
        caps[name] = (pod.step_costs_s, pod.chips, one.step_costs_s, one.chips,
                      pod.step_cost("gemma3-12b", "train_4k"), pod.step_cost("none", "x"),
                      pod.dcn_bandwidth_Bps, pod.dcn_rtt_s)
        # the pods' work seconds come from the artifacts
        grid = G.DianaGridRuntime([pod, G.PodCapacity(name="pod-z", chips=64)])
        item = G.WorkItem(user="u", arch="gemma3-12b", shape="train_4k", steps=10)
        caps[name] += (grid.schedule(item), _costs(grid, item))
    assert caps["port"] == caps["reference"]
    assert caps["port"][0][("gemma3-12b", "train_4k")] == 0.75


def test_h100_constants_and_no_v5e_constant_in_the_port():
    assert (T_cap.PEAK_FLOPS, T_cap.HBM_BW, T_cap.NVLINK_BW) == (989e12, 3.35e12, 900e9)
    assert T.PodCapacity(name="p").flops == 256 * 989e12
    v5e = re.compile(r"\b(197e12|819e9|50e9|197\s*\*\s*1e12)\b")
    for path in sorted((ROOT / "src" / "repro_torch" / "grid").glob("*.py")):
        assert not v5e.search(path.read_text()), f"{path.name} holds a TPU v5e constant"
    src = (ROOT / "src" / "repro_torch" / "grid" / "capacity.py").read_text()
    assert "H100 SXM data sheet" in src


def test_defaults_that_decisions_read_are_the_references():
    a, b = T.PodCapacity(name="p"), R.PodCapacity(name="p")
    assert (a.chips, a.dcn_bandwidth_Bps, a.dcn_loss_rate, a.dcn_rtt_s) == \
        (b.chips, b.dcn_bandwidth_Bps, b.dcn_loss_rate, b.dcn_rtt_s)
    assert T.__all__ == R.__all__
