"""Pure §IV/§V placement engine over packed site views.

The algorithm — cost planes, per-class ranking, selection, sequential
replay — owns no site state and runs against any ``SitePack`` view, on
the view's device. ``DianaScheduler`` hands it packs built from its
authoritative dicts. Results are a pure function of the view. The
two-level ("hier") variants resolve the same decisions through a
``TierPack``'s tier bounds.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .batch import (
    BatchPlacement,
    JobPack,
    SitePack,
    TierPack,
    batched_cost_matrix,
    fused_argmin,
    hier_replay,
    hier_select,
    replay_on_pack,
)
from .costs import CostWeights
from .queues import Job
from .scheduler import JobClass

__all__ = ["PlacementEngine"]


class PlacementEngine:
    """Stateless-by-construction §IV/§V evaluator: every method takes
    the pack it should believe. Only the cost weights are configuration.
    """

    def __init__(self, weights: CostWeights = CostWeights()):
        self.weights = weights

    # -- §IV -----------------------------------------------------------------
    def cost_matrix(
        self,
        jp: JobPack,
        sp: SitePack,
        *,
        mask_dead: bool = True,
        backend: str = "exact",
    ) -> torch.Tensor:
        """Per-class (J, S) §IV cost over the view; dead sites +inf."""
        return batched_cost_matrix(jp, sp, self.weights, mask_dead=mask_dead, backend=backend)

    # -- §V ------------------------------------------------------------------
    def rank(self, jp: JobPack, sp: SitePack) -> list[list[tuple[str, float]]]:
        """Ascending-cost ranking per job (stable: ties keep column
        order); dead sites stay in the ranking, like ``rank_sites``."""
        cost = self.cost_matrix(jp, sp, mask_dead=False)
        order = torch.argsort(cost, dim=1, stable=True)
        names = sp.names
        return [
            [(names[s], row[s]) for s in ranked]
            for row, ranked in zip(cost.tolist(), order.tolist())
        ]

    def select(self, jp: JobPack, sp: SitePack) -> BatchPlacement:
        """Snapshot selection: cheapest alive site per job against one
        frozen view (no feedback between rows), through the fused row
        argmin — on the card no (J, S) plane is written."""
        return fused_argmin(jp, sp, self.weights)

    def replay(self, jp: JobPack, sp: SitePack) -> BatchPlacement:
        """Sequential-equivalent placement with per-row queue feedback;
        mutates the pack's queue/work columns."""
        return replay_on_pack(jp, sp, self.weights)

    # -- two-level ("hier") variants ------------------------------------------
    def select_hier(self, jp: JobPack, sp: SitePack, tp: TierPack) -> BatchPlacement:
        """``select`` through the tier bounds — bit-identical choices
        and costs without materializing the (J, S) plane."""
        return hier_select(jp, sp, tp, self.weights)

    def replay_hier(self, jp: JobPack, sp: SitePack, tp: TierPack) -> BatchPlacement:
        """``replay`` through the tier bounds — bit-identical, including
        the pack's queue/work feedback."""
        return hier_replay(jp, sp, tp, self.weights)

    # -- convenience ----------------------------------------------------------
    def pack_jobs(
        self,
        jobs: Sequence[Job],
        job_classes: Optional[Sequence[Optional[JobClass]]] = None,
        *,
        device=None,
    ) -> JobPack:
        return JobPack.from_jobs(jobs, job_classes, device=device)
