"""Invariants for the split-brain partition scenario.

The heal is the contract:

1. conservation through the split — both halves keep draining their
   work, nothing is stranded;
2. no completion (or start) on the dead south site inside its outage
   window, even though the north half couldn't learn about the death
   until the trunk healed — stale submissions must bounce, not run;
3. post-heal reconvergence — every peer's view reaches the owners'
   authoritative content within k gossip rounds after the window, and
   the settled views equal the no-partition twin's;
4. the episode demonstrably happened (cross-tier drops and full-sync
   escalations were recorded) and cost a bounded makespan.
"""
from __future__ import annotations

from ..common import (
    ScenarioViolation,
    check_all_reconverged,
    check_baseline,
    check_conservation,
    check_no_dead_completions,
    check_views_equal,
    collect_metrics,
    view_snapshot,
)
from .generator import no_partition_twin

MAKESPAN_SLACK = 1.25
K_ROUNDS = 6


def verify(spec, sim, result, baseline=None) -> dict:
    check_conservation(sim, result)
    metrics = collect_metrics(result)
    if metrics["finished"] == 0:
        raise ScenarioViolation("no job finished")

    checked = check_no_dead_completions(result, spec.fault_plan)
    if checked == 0:
        raise ScenarioViolation(
            "no retained record ever touched the dead site — the outage "
            "tested nothing"
        )

    st = sim.exchange.stats
    if st.dropped == 0:
        raise ScenarioViolation(
            "partition window recorded zero dropped messages — the "
            "split never engaged"
        )
    if st.sync_escalations == 0:
        raise ScenarioViolation(
            "no retransmit chain exhausted during a multi-interval "
            "partition — escalation to full sync never fired"
        )

    # Post-heal: the settle rounds run after the window closed, so the
    # transport is whole again; every peer must reconverge.
    rounds = check_all_reconverged(sim, result, k_rounds=K_ROUNDS)
    snap = view_snapshot(sim)

    n_sim, n_result = no_partition_twin(spec).run()
    check_conservation(n_sim, n_result)
    n_metrics = collect_metrics(n_result)
    check_all_reconverged(n_sim, n_result, k_rounds=K_ROUNDS)
    check_views_equal(snap, view_snapshot(n_sim), "partition vs no-partition")
    ratio = metrics["makespan"] / n_metrics["makespan"]
    if ratio > MAKESPAN_SLACK:
        raise ScenarioViolation(
            f"split-brain makespan degradation {ratio:.3f}x exceeds "
            f"{MAKESPAN_SLACK}x the no-partition twin"
        )

    metrics = dict(
        metrics,
        reconverge_rounds=rounds,
        makespan_ratio_vs_no_partition=round(ratio, 4),
        dropped=st.dropped,
        retransmits=st.retransmits,
        sync_escalations=st.sync_escalations,
        dead_site_records=checked,
    )
    check_baseline(metrics, baseline, spec.scale)
    return metrics
