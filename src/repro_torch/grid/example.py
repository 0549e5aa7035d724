"""``examples/grid_schedule.py``'s scenario as a function of a grid
package, and the decisions the reference takes in it, pinned.

``run_example(G)`` runs the example over ``G`` (a module with
``DianaGridRuntime``, ``PodCapacity`` and ``WorkItem``: this package or
the reference's ``repro.grid``) with its three pods at their default
capacities (the example's branch when no dry-run artifacts exist): a
12-job bulk sweep split three ways (§VIII), one production job placed
alone (§V), a pod degraded to 40% (§IX) and a pod lost (C7). It returns
every decision, each work item named by its place in the scenario
(``sweep0`` … ``sweep11``, ``prod``) so that two runs compare whatever
ids their items drew. ``PINNED`` is what the reference returned
(``tests/test_torch_grid.py`` holds both packages to it, and
``chip_smoke.py`` the port on the card machine).
"""
from __future__ import annotations

__all__ = ["run_example", "PINNED"]

PODS = ("pod-us-east", "pod-us-west", "pod-eu")
DCN_BPS = (25e9, 12e9, 6e9)          # heterogeneous DCN


def run_example(G) -> dict:
    pods = []
    for name, bw in zip(PODS, DCN_BPS):
        cap = G.PodCapacity(name=name, chips=256)
        cap.dcn_bandwidth_Bps = bw
        pods.append(cap)
    grid = G.DianaGridRuntime(pods, quotas={"sweep": 100.0, "prod": 1000.0})
    sweep = [G.WorkItem(user="sweep", arch="gemma3-12b", shape="train_4k", steps=500,
                        data_bytes=24e9, resident_pod="pod-us-east") for _ in range(12)]
    label = {id(it): f"sweep{i}" for i, it in enumerate(sweep)}
    placed = grid.schedule_bulk(sweep, division_factor=3)
    out = {
        "bulk": {pod: [label[id(it)] for it in items] for pod, items in placed.items()},
        "queued_s": {pod: grid.pods[pod].queued_seconds() for pod in placed},
    }
    prod = G.WorkItem(user="prod", arch="deepseek-v2-236b", shape="train_4k", steps=100,
                      data_bytes=470e9, resident_pod="pod-us-west")
    label[id(prod)] = "prod"
    where = grid.schedule(prod)
    out["prod"] = where
    out["placement_cost"] = {p: grid.placement_cost(prod, p) for p in PODS}
    grid.set_degraded("pod-eu", 0.4)
    out["moved"] = [(label[id(it)], target) for it, target in grid.mitigate_stragglers()]
    orphans = grid.pod_failed("pod-us-west")
    out["orphans"] = [(label[id(o)], o.pod) for o in orphans]
    out["healthy"] = [n for n, h in grid.pods.items() if h.healthy]
    out["queues"] = {n: [label[id(it)] for it in h.queue] for n, h in grid.pods.items()}
    return out


PINNED = {
    "bulk": {
        "pod-us-east": ["sweep0", "sweep1", "sweep2", "sweep3"],
        "pod-us-west": ["sweep4", "sweep5", "sweep6", "sweep7"],
        "pod-eu": ["sweep8", "sweep9", "sweep10", "sweep11"],
    },
    "queued_s": {"pod-us-east": 7.8125, "pod-us-west": 7.8125, "pod-eu": 7.8125},
    "prod": "pod-us-west",
    "placement_cost": {"pod-us-east": 27.003125, "pod-us-west": 8.59375,
                       "pod-eu": 86.53645833333333},
    "moved": [("sweep8", "pod-us-west"), ("sweep9", "pod-us-west"), ("sweep10", "pod-us-west")],
    "orphans": [("sweep4", "pod-us-east"), ("sweep5", "pod-us-east"), ("sweep6", "pod-us-east"),
                ("sweep7", "pod-eu"), ("prod", "pod-us-east"), ("sweep8", "pod-us-east"),
                ("sweep9", "pod-us-east"), ("sweep10", "pod-eu")],
    "healthy": ["pod-us-east", "pod-eu"],
    "queues": {
        "pod-us-east": ["sweep0", "sweep1", "sweep2", "sweep3", "sweep4", "sweep5", "sweep6",
                        "prod", "sweep8", "sweep9"],
        "pod-us-west": [],
        "pod-eu": ["sweep11", "sweep7", "sweep10"],
    },
}
