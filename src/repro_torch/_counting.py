"""Counting work that no dispatch mode sees, for the dry run's analysis.

A kernel launch is a ``ctypes`` call, which no PyTorch dispatch mode
sees. Each attention wrapper therefore charges its kernel's work, (FLOPs,
bytes) from its ``ops.work`` function, through ``charge`` to every
counter that ``counting`` has made active: on the card where it
launches, and on the ``meta`` route where it only computes shapes, so a
counted run on either device sees the same work. With no counter active
``charge`` does nothing. ``launch.op_analysis.OpAnalysis`` is the counter
the dry run uses.

``trips(n)`` is a loop of n identical trips (the training step's
microbatches): ``range(n)``, unless an active counter counts trips, in
which case the body runs once with every count scaled by n, as the
reference's HLO analysis multiplies a ``while`` body by its trip count.
Only a counter on the ``meta`` device (where nothing is computed) may
count trips.
"""
from __future__ import annotations

import contextlib

__all__ = ["charge", "counting", "trips"]

_active: list = []


def charge(kernel: str, flops: int, nbytes: int) -> None:
    """Add one call of ``kernel`` doing ``flops`` and moving ``nbytes`` to
    every active counter (its ``kernel_work(kernel, flops, nbytes)``)."""
    for counter in _active:
        counter.kernel_work(kernel, flops, nbytes)


@contextlib.contextmanager
def counting(counter):
    """Make ``counter`` active for the block."""
    _active.append(counter)
    try:
        yield counter
    finally:
        _active.remove(counter)


def trips(n: int):
    """The indices of a loop of ``n`` identical trips (module note)."""
    tripping = [c for c in _active if getattr(c, "counts_trips", False)]
    if not tripping or n <= 1:
        yield from range(n)
        return
    for c in tripping:
        c.scale *= n
    try:
        yield 0
    finally:
        for c in tripping:
            c.scale //= n
