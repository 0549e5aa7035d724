"""Invariants for the peer churn scenario.

Three properties make churn "safe" here:

1. conservation through the leave/join cycle (no job stranded in the
   departed peer's hand-off),
2. the rejoined peer reconverges to the omniscient view within k
   gossip rounds — on the delta wire *and* the full wire, so the
   delta path's forced full-sync is equivalent to shipping the table,
3. makespan degrades at most 5% against the no-churn twin.
"""
from __future__ import annotations

from ..common import (
    ScenarioViolation,
    check_baseline,
    check_conservation,
    check_reconvergence,
    collect_metrics,
)
from .generator import full_wire_twin, no_churn_twin

MAKESPAN_SLACK = 1.05
K_ROUNDS = 4


def verify(spec, sim, result, baseline=None) -> dict:
    check_conservation(sim, result)
    metrics = collect_metrics(result)
    if metrics["finished"] == 0:
        raise ScenarioViolation("no job finished")

    peer = spec.params["leave_peer"]
    rounds_delta = check_reconvergence(sim, result, peer, k_rounds=K_ROUNDS)

    # The full wire must resynchronize the same joiner just as fast —
    # the delta wire's rejoin full-sync is a compression detail, not a
    # different protocol.
    f_sim, f_result = full_wire_twin(spec).run()
    check_conservation(f_sim, f_result)
    rounds_full = check_reconvergence(f_sim, f_result, peer, k_rounds=K_ROUNDS)
    f_metrics = collect_metrics(f_result)
    if f_metrics["finished"] != metrics["finished"]:
        raise ScenarioViolation(
            "delta and full wires finished different job counts: "
            f"{metrics['finished']} vs {f_metrics['finished']}"
        )

    # Churn is cheap: the leave/join cycle costs at most 5% makespan
    # against the identical deployment without churn.
    n_sim, n_result = no_churn_twin(spec).run()
    check_conservation(n_sim, n_result)
    n_metrics = collect_metrics(n_result)
    ratio = metrics["makespan"] / n_metrics["makespan"]
    if ratio > MAKESPAN_SLACK:
        raise ScenarioViolation(
            f"churn makespan degradation {ratio:.3f}x exceeds "
            f"{MAKESPAN_SLACK}x the no-churn twin"
        )

    metrics = dict(
        metrics,
        reconverge_rounds_delta=rounds_delta,
        reconverge_rounds_full=rounds_full,
        makespan_ratio_vs_no_churn=round(ratio, 4),
    )
    check_baseline(metrics, baseline, spec.scale)
    return metrics
