"""Invariants for the site failure + recovery scenario."""
from __future__ import annotations

from ..common import (
    ScenarioViolation,
    check_baseline,
    check_conservation,
    check_no_dead_completions,
    collect_metrics,
)


def verify(spec, sim, result, baseline=None) -> dict:
    plan = spec.fault_plan
    check_conservation(sim, result)
    check_no_dead_completions(result, plan)
    metrics = collect_metrics(result)
    # The failures must actually displace work — the data site feeds
    # the failing sites real queues, so a zero requeue count means the
    # fault never interleaved into the run.
    if metrics["requeued"] == 0:
        raise ScenarioViolation("site failures displaced no jobs")
    # Displaced jobs survive: every requeue event is visible on some
    # job record, and displaced jobs still finished somewhere alive.
    displaced = [j for j in result.jobs if j.requeues > 0]
    if not displaced:
        raise ScenarioViolation("requeued counter rose but no job records it")
    if sum(j.requeues for j in result.jobs) != (
        metrics["requeued"] + metrics["redirected"]
    ):
        raise ScenarioViolation(
            "per-job requeue counts disagree with the stream counters"
        )
    for j in displaced:
        if j.finish < 0:
            raise ScenarioViolation("a displaced job never finished")
        if plan.dead_at(j.exec_site, j.finish):
            raise ScenarioViolation(
                f"displaced job finished on dead site {j.exec_site}"
            )
    # Recovery is real: each failed site executes again after its up
    # event (the timeline's "executed" buckets resume past t_up).
    bucket = result.bucket_s
    for site, t_down, t_up in spec.params["down"]:
        series = result.timeline[site]["executed"]
        lo = int(t_up / bucket)
        if not any(series[lo:]):
            raise ScenarioViolation(
                f"{site} never executed again after recovering at {t_up}"
            )
        if not result.timeline[site]["requeued"]:
            raise ScenarioViolation(f"{site} shows no requeue bucket")
    check_baseline(metrics, baseline, spec.scale)
    return metrics
