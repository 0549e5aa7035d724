"""A cell, found by its name in ``BENCHMARK.json``, and everything it names.

Each piece sits in files of its own, found by name:

  configuration   the ``file`` of its entry in ``configs``: the published
                  values, and under ``program_departs`` each key that
                  the port computes otherwise, with the value it runs
  traffic mix     ``portbench/traffic/<traffic>.json``
  limits          ``portbench/limits/<cell>.json``: the correctness
                  comparison's sample and limits, with their readings
  metric          ``portbench/metrics/<metric>.py``, its ``read(run)``

A cell reports every end-to-end metric without a ``workloads`` list or
whose list names it; a per-layer metric where its list names the cell,
or, without a list, wherever the end-to-end metric it moves is reported.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

from .traffic import load_mix

__all__ = ["Cell", "as_run", "resolve", "reader"]


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    mix: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def as_run(config: dict) -> dict:
    """The configuration as the program runs it: the published values, each
    key of ``program_departs`` at the value the port runs instead."""
    return config | {k: v["runs"] for k, v in config.get("program_departs", {}).items()}


def resolve(root: Path, name: str) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, chips=cell["chips"], config_name=conf["name"],
                config=as_run(json.loads((root / conf["file"]).read_text())), traffic_name=cell["traffic"],
                mix=load_mix(root, cell["traffic"]),
                limits=json.loads((root / "portbench" / "limits" / f"{name}.json").read_text()),
                end_to_end=e2e, per_layer=layer)


def reader(root: Path, metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics:{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
