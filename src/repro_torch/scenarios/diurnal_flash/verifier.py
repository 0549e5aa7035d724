"""Invariants for the diurnal flash-crowd scenario."""
from __future__ import annotations

from ..common import (
    ScenarioViolation,
    check_baseline,
    check_conservation,
    collect_metrics,
)


def verify(spec, sim, result, baseline=None) -> dict:
    check_conservation(sim, result)
    metrics = collect_metrics(result)
    if metrics["finished"] == 0:
        raise ScenarioViolation("flash crowd produced no finished jobs")
    # The spike instants must show up as same-instant arrival cohorts.
    spikes = spec.params["spikes"]
    spike_total = sum(n for _, n in spikes)
    cohort = sum(
        1 for j in result.jobs
        if any(j.arrival == at for at, _ in spikes)
    )
    if cohort < spike_total:
        raise ScenarioViolation(
            f"only {cohort} of {spike_total} spike jobs arrived at their "
            f"scripted instants"
        )
    # Flash crowds must actually stress the grid: the p99 turnaround
    # has to exceed the median (a flat tail means the spikes vanished).
    if metrics["p99_turnaround"] < metrics["p50_turnaround"]:
        raise ScenarioViolation("turnaround tail below the median")
    check_baseline(metrics, baseline, spec.scale)
    return metrics
