"""Job migration between peers (paper §IX).

Peer-selection criteria: minimum queue length and minimum cost to place
the job remotely. The scheduler polls peers for (queue length, total
cost, jobsAhead) where jobsAhead counts queued jobs with priority ≥ the
candidate job's priority. If the best peer's jobsAhead beats the local
value, the job's priority is bumped and it migrates — once. A migrated
job is pinned, which prevents cycling. Only low-priority (Q4) jobs
migrate under congestion (§X).

The scalar ``select_peer`` is plain Python. The (J, S) passes
(``select_peer_targets``, its lazy twin and ``select_peers_batch``) run
on torch tensors on the planes' device: inputs may be tensors, NumPy
arrays or lists, and the results are tensors on that device. When no
input is a tensor they run on ``device``, which defaults to the CUDA
card and raises without one, like every entry point of the port. Every
reduction keeps NumPy's semantics exactly — the first index wins ties,
a NaN wins a minimum (``np.min``/``np.argmin``), and ``argmax`` of an
all-False row is 0 — through ``first_min_index``/``first_true_index``,
which do not lean on torch's own argmin tie rules.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from .._device import resolve_device
from .queues import Job, MultilevelFeedbackQueues, is_congested  # noqa: F401

__all__ = [
    "PeerView",
    "MigrationDecision",
    "apply_migration",
    "first_min_index",
    "first_true_index",
    "select_peer",
    "select_peer_targets",
    "select_peer_targets_lazy",
    "select_peers_batch",
    "staleness_excluded",
    "migrate_congested",
]

_F64 = torch.float64
_INF = float("inf")


@dataclass(frozen=True)
class PeerView:
    """What a peer reports when polled (§IX)."""

    name: str
    queue_length: int
    jobs_ahead: int
    total_cost: float          # §IV cost of placing the job there
    alive: bool = True


@dataclass
class MigrationDecision:
    migrate: bool
    target: Optional[str] = None
    reason: str = ""


def select_peer(
    job: Job,
    local_name: str,
    local_jobs_ahead: int,
    local_cost: float,
    peers: list[PeerView],
) -> MigrationDecision:
    """§IX algorithm: find the peer with min jobsAhead, tie-broken by
    min cost; migrate only if it strictly beats the local site."""
    if job.migrated:
        return MigrationDecision(False, reason="pinned: already migrated once")
    alive = [p for p in peers if p.alive and p.name != local_name]
    if not alive:
        return MigrationDecision(False, reason="no alive peers")
    best = min(alive, key=lambda p: (p.jobs_ahead, p.total_cost))
    if best.jobs_ahead < local_jobs_ahead and best.total_cost <= local_cost:
        return MigrationDecision(True, target=best.name, reason="peer has fewer jobs ahead at lower cost")
    if best.jobs_ahead < local_jobs_ahead and best.total_cost < float("inf"):
        # Paper's primary criterion is jobsAhead; cost is the tiebreaker,
        # but a congested local site still prefers the shorter queue.
        return MigrationDecision(True, target=best.name, reason="peer has fewer jobs ahead")
    return MigrationDecision(False, reason="local site is no worse")


# ---------------------------------------------------------------------------
# NumPy's reductions, spelled out on tensors.
# ---------------------------------------------------------------------------

def first_true_index(mask: torch.Tensor) -> torch.Tensor:
    """``np.argmax(mask, axis=-1)`` of a bool tensor: the first True
    column per row, 0 where a row has none."""
    n = mask.shape[-1]
    col = torch.arange(n, device=mask.device)
    idx = torch.where(mask, col, n).amin(dim=-1)
    return torch.where(idx == n, 0, idx)


def first_min_index(x: torch.Tensor) -> torch.Tensor:
    """``np.argmin(x, axis=-1)``: the first index of the row minimum,
    or of the row's first NaN when it holds one."""
    m = x.amin(dim=-1, keepdim=True)          # NaN-propagating, like np.min
    hit = (x == m) | (torch.isnan(x) & torch.isnan(m))
    return first_true_index(hit)


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F64, device=device)


def _bool(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.bool, device=device)


def _device_of(*xs, device=None) -> torch.device:
    """``device`` when given, else the first tensor input's device, else
    the CUDA card (``resolve_device(None)``, which raises without one)."""
    if device is not None:
        return resolve_device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(None)


def _peer_argmin(
    excluded: torch.Tensor,
    jobs_ahead: torch.Tensor,
    total_cost: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per row, the stable (jobs_ahead, total_cost)-lexicographic min
    over the non-excluded columns: (ja_min (J,), best col (J,), best
    cost (J,)). First index wins ties, like the sequential ``min``."""
    ja = jobs_ahead.masked_fill(excluded[None, :], _INF)
    cost = total_cost.masked_fill(excluded[None, :], _INF)
    ja_min = ja.amin(dim=1)
    candidates = ja == ja_min[:, None]
    best = first_min_index(cost.masked_fill(~candidates, _INF))
    # An all-inf cost row leaves the argmin on a non-candidate column;
    # the sequential min then keeps the first candidate in peer order.
    miss = ~candidates.gather(1, best[:, None])[:, 0]
    best = torch.where(miss, first_true_index(candidates), best)
    return ja_min, best, cost.gather(1, best[:, None])[:, 0]


def staleness_excluded(
    excluded: torch.Tensor,
    staleness,
    max_staleness: float,
    device=None,
) -> torch.Tensor:
    """Fold per-column view staleness into the exclusion mask: §IX
    migration only trusts peers whose advertised rows are fresh enough."""
    excluded = _bool(excluded, _device_of(excluded, staleness, device=device))
    if staleness is None:
        return excluded
    stale = _f64(staleness, excluded.device)
    return excluded | (stale > max_staleness)


def _migrate_mask(pinned, ja_min, lja, best_cost, lcost) -> torch.Tensor:
    return (
        ~pinned
        & (ja_min < lja)
        & ((best_cost <= lcost) | (best_cost < _INF))
    )


def select_peer_targets(
    pinned,
    local_jobs_ahead,
    local_cost,
    excluded,
    jobs_ahead,
    total_cost,
    staleness=None,
    max_staleness: float = float("inf"),
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Array core of ``select_peers_batch``: (migrate (J,) bool, best
    column (J,) int64) on ``total_cost``'s device. ``excluded`` marks
    dead/local columns; ``staleness`` (S,) additionally drops columns
    older than ``max_staleness`` seconds. ``device`` defaults to the
    planes' when they are tensors and to the card otherwise."""
    dev = _device_of(total_cost, jobs_ahead, excluded, device=device)
    tc = _f64(total_cost, dev)
    # A (J, 0) plane (jobs but no peers) still yields (J,) no-migrate
    # rows; only an empty candidate set yields length-0 results. A
    # non-empty 1-D input is a missing [None, :] lift and fails loudly.
    if tc.dim() != 2:
        if tc.numel() == 0:
            return torch.zeros(0, dtype=torch.bool, device=dev), torch.zeros(0, dtype=torch.int64, device=dev)
        raise ValueError(
            f"total_cost must be a (J, S) plane, got shape {tuple(tc.shape)}"
        )
    J, S = tc.shape
    if J == 0 or S == 0:
        return torch.zeros(J, dtype=torch.bool, device=dev), torch.zeros(J, dtype=torch.int64, device=dev)
    excluded = staleness_excluded(_bool(excluded, dev), staleness, max_staleness)
    # The reference returns (all False, all 0) when every column is
    # excluded; the masked argmin gives exactly that (every ja is +inf,
    # so no row beats its local jobs-ahead and column 0 wins), without
    # reading the mask back to the host.
    ja_min, best, best_cost = _peer_argmin(excluded, _f64(jobs_ahead, dev), tc)
    migrate = _migrate_mask(
        _bool(pinned, dev), ja_min, _f64(local_jobs_ahead, dev), best_cost, _f64(local_cost, dev)
    )
    return migrate, best


def _lazy_cost_argmin(
    excluded: torch.Tensor,
    jobs_ahead: torch.Tensor,
    cost_cols: Callable[[torch.Tensor], torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_peer_argmin`` without a dense cost plane.

    The §IX key is (jobs_ahead, total_cost)-lexicographic, so the cost
    only breaks ties within the min-jobs-ahead candidate columns. This
    evaluates ``cost_cols(cols) -> (J, k)`` (``cols`` an int64 tensor on
    the planes' device) exactly once, on the union of candidate columns;
    results are bit-identical to ``_peer_argmin`` over the full plane
    because non-candidate costs are never read there either.
    """
    ja = jobs_ahead.masked_fill(excluded[None, :], _INF)
    ja_min = ja.amin(dim=1)
    candidates = ja == ja_min[:, None]
    need = torch.nonzero(candidates.any(dim=0))[:, 0]
    cost = torch.full(ja.shape, _INF, dtype=_F64, device=ja.device)
    if need.numel():
        cost[:, need] = _f64(cost_cols(need), ja.device)
        cost[:, need[excluded[need]]] = _INF
    best = first_min_index(cost.masked_fill(~candidates, _INF))
    miss = ~candidates.gather(1, best[:, None])[:, 0]
    best = torch.where(miss, first_true_index(candidates), best)
    return ja_min, best, cost.gather(1, best[:, None])[:, 0]


def select_peer_targets_lazy(
    pinned,
    local_jobs_ahead,
    local_cost,
    excluded,
    jobs_ahead,
    cost_cols: Callable[[torch.Tensor], torch.Tensor],
    staleness=None,
    max_staleness: float = float("inf"),
    device=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``select_peer_targets`` with the cost plane evaluated lazily on
    the candidate columns only (see ``_lazy_cost_argmin``). Returns
    ``(migrate, best, best_cost)``; decisions are bit-identical to the
    dense path."""
    dev = _device_of(jobs_ahead, excluded, device=device)
    ja = _f64(jobs_ahead, dev)
    empty = (torch.zeros(0, dtype=torch.bool, device=dev),
             torch.zeros(0, dtype=torch.int64, device=dev),
             torch.zeros(0, dtype=_F64, device=dev))
    if ja.dim() != 2:
        if ja.numel() == 0:
            return empty
        raise ValueError(f"jobs_ahead must be a (J, S) plane, got shape {tuple(ja.shape)}")
    J = ja.shape[0]
    if J == 0:
        return empty
    excluded = staleness_excluded(_bool(excluded, dev), staleness, max_staleness)
    if bool(excluded.all()):
        return (torch.zeros(J, dtype=torch.bool, device=dev),
                torch.zeros(J, dtype=torch.int64, device=dev),
                torch.full((J,), _INF, dtype=_F64, device=dev))
    ja_min, best, best_cost = _lazy_cost_argmin(excluded, ja, cost_cols)
    migrate = _migrate_mask(
        _bool(pinned, dev), ja_min, _f64(local_jobs_ahead, dev), best_cost, _f64(local_cost, dev)
    )
    return migrate, best, best_cost


def select_peers_batch(
    jobs: Sequence[Job],
    local_name: str,
    local_jobs_ahead,
    local_cost,
    names: Sequence[str],
    jobs_ahead,
    total_cost=None,
    alive=None,
    staleness=None,
    max_staleness: float = float("inf"),
    cost_cols: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    device=None,
) -> list[MigrationDecision]:
    """Vectorized ``select_peer`` over a (J, S) peer grid.

    ``names`` fixes the peer iteration order: ties on the
    (jobs_ahead, total_cost) key resolve to the lowest column index,
    like the stable ``min`` walk over a ``PeerView`` list in the same
    order. A column named ``local_name`` (and any dead column) is
    excluded; ``staleness`` (S,) drops columns older than
    ``max_staleness``. Without staleness, decisions — targets and reason
    strings — are identical to ``[select_peer(...) for each job]``.
    Passing ``cost_cols`` instead of ``total_cost`` switches to the lazy
    candidate-column evaluation. ``device`` defaults to the planes' when
    they are tensors and to the card otherwise.
    """
    lazy = cost_cols is not None and total_cost is None
    dev = _device_of(jobs_ahead, total_cost, device=device)
    tc = _f64(jobs_ahead if lazy else total_cost, dev)
    if tc.dim() != 2:
        if tc.numel() == 0 and len(jobs) == 0:
            return []
        raise ValueError(f"total_cost must be a (J, S) plane, got shape {tuple(tc.shape)}")
    J, S = tc.shape
    if J == 0:
        return []
    alive = torch.ones(S, dtype=torch.bool, device=dev) if alive is None else _bool(alive, dev)
    excluded = ~alive | _bool([n == local_name for n in names], dev)
    all_dead = bool(excluded.all())
    excluded = staleness_excluded(excluded, staleness, max_staleness)
    if bool(excluded.all()):
        # "every peer dead/local" (the sequential reason) versus "alive
        # peers exist but none fresh enough".
        no_peer = "no alive peers" if all_dead else "no sufficiently fresh peers"
        return [
            MigrationDecision(False, reason="pinned: already migrated once")
            if j.migrated
            else MigrationDecision(False, reason=no_peer)
            for j in jobs
        ]
    ja = _f64(jobs_ahead, dev)
    if lazy:
        ja_min, best, best_cost = _lazy_cost_argmin(excluded, ja, cost_cols)
    else:
        ja_min, best, best_cost = _peer_argmin(excluded, ja, tc)
    lja = _f64(local_jobs_ahead, dev).tolist()
    lcost = _f64(local_cost, dev).tolist()
    ja_min, best, best_cost = ja_min.tolist(), best.tolist(), best_cost.tolist()
    decisions: list[MigrationDecision] = []
    for j in range(J):
        if jobs[j].migrated:
            decisions.append(MigrationDecision(False, reason="pinned: already migrated once"))
        elif ja_min[j] < lja[j] and best_cost[j] <= lcost[j]:
            decisions.append(MigrationDecision(
                True, target=names[best[j]], reason="peer has fewer jobs ahead at lower cost"))
        elif ja_min[j] < lja[j] and best_cost[j] < float("inf"):
            decisions.append(MigrationDecision(
                True, target=names[best[j]], reason="peer has fewer jobs ahead"))
        else:
            decisions.append(MigrationDecision(False, reason="local site is no worse"))
    return decisions


def apply_migration(job: Job, decision: MigrationDecision, priority_bump: float = 0.1) -> Job:
    """§IX: 'increase the job's priority, migrate the job to that site'."""
    if not decision.migrate or decision.target is None:
        return job
    job.priority = min(1.0, job.priority + priority_bump)
    job.migrated = True
    job.site = decision.target
    return job


def migrate_congested(
    queues: MultilevelFeedbackQueues,
    local_name: str,
    poll_peers: Callable[[Job], list[PeerView]],
    local_cost: Callable[[Job], float],
    window: float,
    now: float,
    max_moves: Optional[int] = None,
) -> list[tuple[Job, str]]:
    """§X congestion response: while the arrival/service imbalance
    exceeds Thrs, push low-priority (Q4) jobs to better peers."""
    moved: list[tuple[Job, str]] = []
    if not queues.congested(window, now):
        return moved
    for job in list(queues.low_priority_jobs()):
        if max_moves is not None and len(moved) >= max_moves:
            break
        peers = poll_peers(job)
        decision = select_peer(
            job,
            local_name,
            queues.jobs_ahead(job.priority),
            local_cost(job),
            peers,
        )
        if decision.migrate and decision.target is not None:
            queues.remove(job)
            apply_migration(job, decision)
            moved.append((job, decision.target))
    return moved
