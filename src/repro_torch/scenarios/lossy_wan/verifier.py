"""Invariants for the lossy WAN scenario.

Four properties make the unreliable transport "survivable":

1. conservation — every admitted job still drains through the lossy
   run (gossip loss may misplace work, never lose it);
2. eventual reconvergence — every peer's world view reaches the
   owners' authoritative content within k extra gossip rounds while
   the transport keeps dropping/duplicating/corrupting;
3. view equivalence — the settled views equal the lossless twin's
   (loss delays knowledge, it must not corrupt it) and the full-wire
   twin's (both wire formats degrade to the same place);
4. bounded degradation — the lossy makespan is at most 5% worse than
   the lossless twin's.

The transport must also demonstrably *do* something: the run has to
record drops and retransmissions, otherwise the scenario is testing
nothing.
"""
from __future__ import annotations

from ..common import (
    ScenarioViolation,
    check_all_reconverged,
    check_baseline,
    check_conservation,
    check_views_equal,
    collect_metrics,
    view_snapshot,
)
from .generator import full_wire_twin, lossless_twin

MAKESPAN_SLACK = 1.05
K_ROUNDS = 6


def verify(spec, sim, result, baseline=None) -> dict:
    check_conservation(sim, result)
    metrics = collect_metrics(result)
    if metrics["finished"] == 0:
        raise ScenarioViolation("no job finished")

    st = sim.exchange.stats
    if st.dropped == 0:
        raise ScenarioViolation(
            "transport recorded zero drops — the fault model never engaged"
        )
    if st.retransmits == 0:
        raise ScenarioViolation(
            "transport dropped packets but the exchange never retransmitted"
        )

    rounds = check_all_reconverged(sim, result, k_rounds=K_ROUNDS)
    snap = view_snapshot(sim)

    # Lossless twin: same deployment, perfect transport.
    l_sim, l_result = lossless_twin(spec).run()
    check_conservation(l_sim, l_result)
    l_metrics = collect_metrics(l_result)
    check_all_reconverged(l_sim, l_result, k_rounds=K_ROUNDS)
    check_views_equal(snap, view_snapshot(l_sim), "lossy vs lossless")
    if l_metrics["finished"] != metrics["finished"]:
        raise ScenarioViolation(
            "lossy and lossless runs finished different job counts: "
            f"{metrics['finished']} vs {l_metrics['finished']}"
        )
    ratio = metrics["makespan"] / l_metrics["makespan"]
    if ratio > MAKESPAN_SLACK:
        raise ScenarioViolation(
            f"lossy makespan degradation {ratio:.3f}x exceeds "
            f"{MAKESPAN_SLACK}x the lossless twin"
        )

    # Full-wire twin: same loss, uncompressed protocol.
    f_sim, f_result = full_wire_twin(spec).run()
    check_conservation(f_sim, f_result)
    check_all_reconverged(f_sim, f_result, k_rounds=K_ROUNDS)
    check_views_equal(snap, view_snapshot(f_sim), "delta vs full wire")

    metrics = dict(
        metrics,
        reconverge_rounds=rounds,
        makespan_ratio_vs_lossless=round(ratio, 4),
        dropped=st.dropped,
        duplicated=st.duplicated,
        dup_suppressed=st.dup_suppressed,
        corrupted=st.corrupted,
        reordered=st.reordered,
        retransmits=st.retransmits,
        sync_escalations=st.sync_escalations,
    )
    check_baseline(metrics, baseline, spec.scale)
    return metrics
