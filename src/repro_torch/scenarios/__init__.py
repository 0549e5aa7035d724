"""Scenario pack: fault-injecting generators and invariant verifiers,
held to the reference's recorded baselines.

Each scenario is a directory with ``generator.py`` (``generate(scale,
seed) -> ScenarioSpec``: the workload, the grid and a ``FaultPlan``) and
``verifier.py`` (``verify(spec, sim, result, baseline) -> dict``: the
invariants, raising :class:`ScenarioViolation` on the first breach, and
the metrics it checked). The recorded envelopes are the reference's
``baseline.json`` files, read in place.

Run them via the CLI (the simulators run on the CUDA card unless
``--device cpu``)::

    python -m repro_torch.scenarios list
    python -m repro_torch.scenarios smoke --device cpu
    python -m repro_torch.scenarios run peer_churn --scale bench
    python -m repro_torch.scenarios record --out DIR --scale both
"""
from __future__ import annotations

import importlib
from typing import Callable, Optional

from .._device import resolve_device
from .common import (
    DEFAULT_REL_TOL,
    SCALES,
    ScenarioSpec,
    ScenarioViolation,
    baseline_path,
    collect_metrics,
    grid16,
    load_baseline,
    record_baseline,
)

__all__ = [
    "SCENARIOS",
    "SCALES",
    "DEFAULT_REL_TOL",
    "ScenarioSpec",
    "ScenarioViolation",
    "baseline_path",
    "collect_metrics",
    "generate",
    "get_generator",
    "get_verifier",
    "grid16",
    "load_baseline",
    "record_baseline",
    "run_scenario",
]

SCENARIOS = (
    "diurnal_flash",
    "site_failure",
    "peer_churn",
    "wan_tiers",
    "lossy_wan",
    "partition",
)


def _module(name: str, part: str):
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; one of {SCENARIOS}")
    return importlib.import_module(f"{__name__}.{name}.{part}")


def get_generator(name: str) -> Callable[..., ScenarioSpec]:
    return _module(name, "generator").generate


def get_verifier(name: str) -> Callable[..., dict]:
    return _module(name, "verifier").verify


def generate(name: str, scale: str = "smoke", seed: int = 0) -> ScenarioSpec:
    return get_generator(name)(scale=scale, seed=seed)


def run_scenario(
    name: str,
    scale: str = "smoke",
    seed: int = 0,
    baseline: Optional[dict] = None,
    use_recorded_baseline: bool = True,
    *,
    device=None,
) -> tuple[ScenarioSpec, "object", "object", dict]:
    """Generate, run and verify one scenario on ``device`` (the CUDA
    card unless ``device="cpu"``; raises when there is none).

    Returns ``(spec, sim, result, metrics)``; raises
    :class:`ScenarioViolation` if any invariant fails. ``baseline``
    overrides the recorded envelope (``{}`` or
    ``use_recorded_baseline=False`` skips the envelope checks).
    """
    dev = resolve_device(device)
    spec = generate(name, scale=scale, seed=seed)
    spec.device = dev
    sim, result = spec.run()
    if baseline is None and use_recorded_baseline:
        baseline = load_baseline(name)
    metrics = get_verifier(name)(spec, sim, result, baseline=baseline)
    return spec, sim, result, metrics
