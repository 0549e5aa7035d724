"""Invariants for the heterogeneous WAN tiers scenario."""
from __future__ import annotations

from ..common import (
    ScenarioViolation,
    check_baseline,
    check_conservation,
    collect_metrics,
)
from .generator import EAST_TO_WEST_BW, WEST_TO_EAST_BW, tier_map

# A degraded east→west plane makes cross-tier placement strictly more
# expensive, so window arrivals may cross *less*, never meaningfully
# more. Small absolute slack absorbs queue-pressure edge cases.
CROSS_SLACK = 0.10


def _fractions(result, tiers, data_tier, t0, t1):
    in_window = [[], []]
    for j in result.jobs:
        if j.finish < 0:
            continue
        cohort = in_window[0] if t0 <= j.arrival < t1 else in_window[1]
        cohort.append(tiers[j.exec_site] != data_tier)
    win, rest = in_window
    frac = lambda xs: (sum(xs) / len(xs)) if xs else 0.0
    return frac(win), frac(rest), len(win)


def verify(spec, sim, result, baseline=None) -> dict:
    p = spec.params
    check_conservation(sim, result)
    metrics = collect_metrics(result)
    if metrics["finished"] == 0:
        raise ScenarioViolation("no job finished")

    names = sorted(spec.site_nodes)
    tiers = tier_map(names)
    east = [n for n in names if tiers[n] == "east"]
    west = [n for n in names if tiers[n] == "west"]

    # The planes really are asymmetric, and the mid-run degradation was
    # restored: the post-run link table must equal the construction one.
    e2w = sim.links[(east[0], west[0])]
    w2e = sim.links[(west[0], east[0])]
    if not (e2w.bandwidth_Bps == EAST_TO_WEST_BW
            and w2e.bandwidth_Bps == WEST_TO_EAST_BW):
        raise ScenarioViolation(
            "cross-tier plane not restored to the asymmetric baseline: "
            f"e→w {e2w.bandwidth_Bps:g}, w→e {w2e.bandwidth_Bps:g}"
        )
    if sim.links[(east[0], east[1])].bandwidth_Bps <= EAST_TO_WEST_BW:
        raise ScenarioViolation("intra-tier plane slower than WAN plane")

    # Data-locality respects the degradation: arrivals inside the
    # degraded window cross away from the data tier at most as often
    # as everyone else (plus slack).
    cross_window, cross_rest, n_window = _fractions(
        result, tiers, p["data_tier"], p["t_degrade"], p["t_restore"]
    )
    if n_window == 0:
        raise ScenarioViolation("no job arrived inside the degraded window")
    if cross_window > cross_rest + CROSS_SLACK:
        raise ScenarioViolation(
            f"degraded-window arrivals crossed tiers more often "
            f"({cross_window:.3f}) than the rest ({cross_rest:.3f})"
        )

    metrics = dict(
        metrics,
        cross_tier_fraction_window=round(cross_window, 4),
        cross_tier_fraction_rest=round(cross_rest, 4),
    )
    check_baseline(metrics, baseline, spec.scale)
    return metrics
