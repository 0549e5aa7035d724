"""Shared machinery for the fault-injection scenario pack.

A *scenario* is a directory under ``repro_torch/scenarios/`` with two
parts:

* ``generator.py`` — ``generate(scale, seed) -> ScenarioSpec``: a
  parameterized workload (any ``ArrivalSource``) plus a ``FaultPlan``
  and the simulator configuration to run them under;
* ``verifier.py`` — ``verify(spec, sim, result, baseline) -> dict``:
  asserts the scenario's invariants against the finished run (raising
  ``ScenarioViolation`` on failure) and returns the metrics dict.

The recorded metric envelopes are the reference package's
``src/repro/scenarios/<name>/baseline.json`` files, read in place by
path (``baseline_path``); ``record_baseline`` writes only to a path its
caller names.

A spec runs its simulator on ``ScenarioSpec.device`` (the CUDA card
unless ``"cpu"``). The checks that read the peers' world views take one
device → host copy of each view per check.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from .._device import to_host
from ..sim import GridSim, P2PGridSim, SimConfig, SimResult
from ..sim.faults import FaultPlan

SCALES = ("smoke", "bench")

#: Default relative envelope for time-valued metrics (counts are exact:
#: the simulator is deterministic).
DEFAULT_REL_TOL = 0.15

_COUNT_METRICS = frozenset({"finished", "migrated", "requeued", "redirected"})

#: The reference's scenario directories, whose baseline.json files hold
#: the recorded envelopes (a data file read by path, not an import).
REFERENCE_SCENARIOS = Path(__file__).resolve().parents[2] / "repro" / "scenarios"


class ScenarioViolation(AssertionError):
    """An invariant a finished scenario run was required to satisfy
    does not hold."""


@dataclass
class ScenarioSpec:
    """Everything needed to build and run one scenario instance;
    ``device`` is where its simulators run (None: the CUDA card)."""

    name: str
    scale: str
    site_nodes: dict
    config: SimConfig
    jobs: object                      # list[SimJob] or lazy ArrivalSource
    links: Optional[dict] = None
    p2p: bool = False
    params: dict = field(default_factory=dict)
    device: object = None

    @property
    def fault_plan(self) -> Optional[FaultPlan]:
        return self.config.fault_plan

    def build_sim(self) -> GridSim:
        cls = P2PGridSim if self.p2p else GridSim
        return cls(self.site_nodes, links=self.links, config=self.config, device=self.device)

    def run(self) -> tuple[GridSim, SimResult]:
        sim = self.build_sim()
        return sim, sim.run(self.jobs)


def grid16(nodes: int = 3) -> dict[str, int]:
    """The scenario pack's standard 16-site grid."""
    return {f"site{i:02d}": nodes for i in range(16)}


# -- metrics ---------------------------------------------------------------
def collect_metrics(result: SimResult) -> dict:
    """The scenario pack's canonical metric set (all baseline-able)."""
    s = result.stats
    p50, p95, p99 = result.turnaround_percentiles((0.5, 0.95, 0.99))
    return {
        "finished": s.finished,
        "migrated": s.migrated,
        "requeued": s.requeued,
        "redirected": s.redirected,
        "makespan": result.makespan,
        "avg_queue_time": s.queue_times.mean,
        "avg_turnaround": s.turnarounds.mean,
        "p50_turnaround": p50,
        "p95_turnaround": p95,
        "p99_turnaround": p99,
    }


# -- invariants ------------------------------------------------------------
def check_conservation(sim: GridSim, result: SimResult) -> None:
    """Every admitted job finished and no in-flight bookkeeping
    survived the run."""
    s = result.stats
    if s.finished != s.admitted:
        raise ScenarioViolation(
            f"conservation: admitted {s.admitted} != finished {s.finished} "
            f"(requeued={s.requeued}, redirected={s.redirected})"
        )
    if sim._cj2sj:
        raise ScenarioViolation(
            f"conservation: {len(sim._cj2sj)} in-flight job mapping(s) "
            f"survived run end"
        )
    leftover = [n for n, st in sim.sites.items()
                if st.busy or st.queue_len() or st.running]
    if leftover or sim.central_fifo:
        raise ScenarioViolation(
            f"conservation: residual queue/busy state at {leftover} "
            f"(central={len(sim.central_fifo)})"
        )


def check_no_dead_completions(result: SimResult, plan: FaultPlan) -> int:
    """No retained job record shows a start or completion inside a
    window its executing site was scripted down. Returns the number of
    records checked."""
    down = plan.down_intervals()
    checked = 0
    for j in result.jobs:
        if j.finish < 0 or j.exec_site not in down:
            continue
        checked += 1
        for t0, t1 in down[j.exec_site]:
            if t0 <= j.finish < t1:
                raise ScenarioViolation(
                    f"job finished at t={j.finish} on {j.exec_site}, "
                    f"scripted down over [{t0}, {t1})"
                )
            if t0 <= j.start < t1 and j.start >= 0:
                raise ScenarioViolation(
                    f"job started at t={j.start} on {j.exec_site}, "
                    f"scripted down over [{t0}, {t1})"
                )
    return checked


def check_baseline(
    metrics: dict,
    baseline: Optional[dict],
    scale: str,
    rel_tol: float = DEFAULT_REL_TOL,
) -> None:
    """Compare a run's metrics against the recorded envelope: counts
    exactly, times within the relative envelope. A missing baseline
    passes."""
    if not baseline or scale not in baseline:
        return
    ref = baseline[scale]["metrics"]
    tol = baseline[scale].get("rel_tol", rel_tol)
    for key, want in ref.items():
        got = metrics.get(key)
        if got is None:
            raise ScenarioViolation(f"metric {key!r} missing from run")
        if key in _COUNT_METRICS:
            if int(got) != int(want):
                raise ScenarioViolation(
                    f"count metric {key}: got {got}, baseline {want}"
                )
        elif abs(got - want) > tol * max(abs(want), 1e-9):
            raise ScenarioViolation(
                f"metric {key}: got {got:.6g}, outside ±{tol:.0%} of "
                f"baseline {want:.6g}"
            )


def _host_views(sim: P2PGridSim) -> list[dict]:
    """Each peer's world view on the host: queue, work, load, free,
    alive and version, one device → host copy a peer."""
    out = []
    for p in sim.peers:
        v = p.view
        q, w, ld, fr, al, ver = to_host(v.queue, v.work, v.load, p.free, v.alive, p.version)
        out.append({"queue": q, "work": w, "load": ld, "free": fr, "alive": al, "version": ver})
    return out


def _view_mismatch(
    sim: P2PGridSim, views: list[dict], k: int, rel_tol: float = 1e-3
) -> Optional[str]:
    """First divergence between peer ``k``'s world view and the owning
    peers' authoritative content (None = converged): dynamic fields to
    quantization tolerance, alive bits exact, epochs at least as new."""
    peer, mine = sim.peers[k], views[k]
    index = {id(p): i for i, p in enumerate(sim.peers)}
    for i, n in enumerate(peer.view.names):
        owner = sim._peer_by_site[n]
        theirs = views[index[id(owner)]]
        c = owner._col[n]
        for f in ("queue", "work", "load"):
            a = float(mine[f][i])
            b = float(theirs[f][c])
            if abs(a - b) > rel_tol * max(1.0, abs(b)):
                return f"{n}.{f}: {a} vs owner {b}"
        if bool(mine["alive"][i]) != bool(theirs["alive"][c]):
            return f"{n}.alive mismatch"
        if mine["version"][i] < theirs["version"][c]:
            return f"{n}: epoch {mine['version'][i]} < owner {theirs['version'][c]}"
    return None


def check_reconvergence(
    sim: P2PGridSim,
    result: SimResult,
    peer_idx: int,
    k_rounds: int = 4,
    rel_tol: float = 1e-3,
) -> int:
    """A rejoined peer must reconverge to the owners' view within
    ``k_rounds`` extra gossip rounds after the run. Returns the rounds
    needed."""
    ex = sim.exchange
    t = max(result.makespan, result.stats.last_finish)
    for r in range(1, k_rounds + 1):
        t += sim.exchange_interval_s
        ex.round(t)
        ex.deliver_due(t + sim.exchange_latency_s + 1.0)
        if _view_mismatch(sim, _host_views(sim), peer_idx, rel_tol) is None:
            return r
    raise ScenarioViolation(
        f"peer {peer_idx} did not reconverge within {k_rounds} gossip "
        f"rounds: {_view_mismatch(sim, _host_views(sim), peer_idx, rel_tol)}"
    )


def check_all_reconverged(
    sim: P2PGridSim,
    result: SimResult,
    k_rounds: int = 6,
    rel_tol: float = 1e-3,
) -> int:
    """*Every* peer's world view must reconverge to the owners' content
    within ``k_rounds`` extra gossip rounds after the run, under the
    transport the exchange still has. Returns the rounds needed."""
    ex = sim.exchange
    t = max(result.makespan, result.stats.last_finish)

    def mismatch() -> Optional[str]:
        views = _host_views(sim)
        for k in range(len(sim.peers)):
            msg = _view_mismatch(sim, views, k, rel_tol)
            if msg is not None:
                return f"peer {k}: {msg}"
        return None

    slack = sim.exchange_latency_s + sim.exchange_interval_s
    for r in range(1, k_rounds + 1):
        t += sim.exchange_interval_s
        ex.round(t)
        ex.deliver_due(t + slack)
        if mismatch() is None:
            return r
    raise ScenarioViolation(
        f"peer views did not reconverge within {k_rounds} gossip "
        f"rounds: {mismatch()}"
    )


def view_snapshot(sim: P2PGridSim) -> np.ndarray:
    """Canonical (num_peers, 4, num_sites) host stack of every peer's
    view (queue, work, load, free) for cross-run comparison."""
    return np.stack([
        np.stack([v["queue"], v["work"], v["load"], v["free"]]) for v in _host_views(sim)
    ])


def check_views_equal(
    a: np.ndarray, b: np.ndarray, what: str, rel_tol: float = 1e-3
) -> None:
    """Two settled view snapshots must agree to quantization tolerance."""
    if a.shape != b.shape:
        raise ScenarioViolation(f"{what}: snapshot shapes {a.shape} vs {b.shape}")
    err = np.abs(a - b) / np.maximum(1.0, np.abs(b))
    worst = float(err.max()) if err.size else 0.0
    if worst > rel_tol:
        p, f, s = np.unravel_index(int(err.argmax()), err.shape)
        field = ("queue", "work", "load", "free")[f]
        raise ScenarioViolation(
            f"{what}: settled views diverge (worst rel err {worst:.3g} "
            f"at peer {p}, {field}, site column {s})"
        )


# -- baseline files --------------------------------------------------------
def baseline_path(name: str) -> Path:
    """The recorded envelope of scenario ``name``: the reference's
    ``baseline.json``, read in place."""
    return REFERENCE_SCENARIOS / name / "baseline.json"


def load_baseline(name: str) -> Optional[dict]:
    p = baseline_path(name)
    if not p.exists():
        return None
    with open(p) as f:
        data = json.load(f)
    return data or None


def record_baseline(path, scale: str, metrics: dict,
                    rel_tol: float = DEFAULT_REL_TOL) -> dict:
    """Write one scale's metric envelope into the baseline file at
    ``path`` (created if needed; the recorded envelopes this package
    reads are never written) and return the full baseline dict."""
    p = Path(path)
    data = {}
    if p.exists():
        with open(p) as f:
            data = json.load(f) or {}
    data[scale] = {
        "metrics": {k: (int(v) if k in _COUNT_METRICS else float(v))
                    for k, v in metrics.items()},
        "rel_tol": rel_tol,
    }
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    return data
