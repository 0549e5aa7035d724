"""Carry a scheduler's state across from the reference package.

``state_from_reference`` reads ``SiteState``/``NetworkLink``/``Job``/
``CostWeights`` objects of any origin by attribute only (it imports
nothing of the reference) and returns the port's own objects, every
float carried bit-exactly — the scheduler's counterpart of loading a
model's weights. The array form is ``SitePack.from_arrays``.
"""
from __future__ import annotations

from dataclasses import fields
from typing import NamedTuple, Optional

from .costs import CostWeights, NetworkLink, SiteState
from .queues import Job

__all__ = ["ReferenceState", "state_from_reference"]


class ReferenceState(NamedTuple):
    sites: dict[str, SiteState]
    links: dict[str, NetworkLink]
    jobs: list[Job]
    weights: CostWeights


def _carry(cls, obj):
    """A ``cls`` built from ``obj``'s attributes of the same names."""
    return cls(**{f.name: getattr(obj, f.name) for f in fields(cls)})


def state_from_reference(sites, links, jobs=None, weights: Optional[object] = None) -> ReferenceState:
    """The port's (sites, links, jobs, weights) equal to the given ones.

    ``sites``/``links`` are dicts keyed by site name (order kept: it is
    the tie-break order of placement); ``jobs`` keep their ``job_id``;
    ``weights`` None gives the default ``CostWeights()``.
    """
    return ReferenceState(
        sites={name: _carry(SiteState, s) for name, s in sites.items()},
        links={name: _carry(NetworkLink, link) for name, link in links.items()},
        jobs=[_carry(Job, j) for j in (jobs or [])],
        weights=CostWeights() if weights is None else _carry(CostWeights, weights),
    )
