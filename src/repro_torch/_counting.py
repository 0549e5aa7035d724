"""Counting work that no dispatch mode sees, for the dry run's analysis.

A kernel launch is a ``ctypes`` call, which no PyTorch dispatch mode
sees. Each attention wrapper therefore charges its kernel's work, (FLOPs,
bytes) from its ``ops.work`` function, through ``charge`` to every
counter that ``counting`` has made active: on the card where it
launches, on the ``meta`` route where it only computes shapes, and on
the host, where it runs the plain version inside ``host``, which hides
the plain version's operators from the counters' dispatch modes. So a
counted run on any device sees the kernels' work alike. With no counter
active ``charge`` does nothing. ``launch.op_analysis.OpAnalysis`` is the
counter the dry run uses.

``trips(n)`` is a loop of n identical trips (the training step's
microbatches): ``range(n)``, unless an active counter counts trips, in
which case the body runs once with every count scaled by n, as the
reference's HLO analysis multiplies a ``while`` body by its trip count.
Only a counter on the ``meta`` device (where nothing is computed) may
count trips. ``trip_scale()`` is the number of trips the running body
stands for (1 outside such a loop), by which a count kept outside a
counter (``launch.mesh.received``) scales its own.
"""
from __future__ import annotations

import contextlib

__all__ = ["charge", "counting", "host", "trips", "trip_scale"]

_active: list = []
_scale = 1      # the product of the enclosing counted loops' trips


def charge(kernel: str, flops: int, nbytes: int) -> None:
    """Add one call of ``kernel`` doing ``flops`` and moving ``nbytes`` to
    every active counter (its ``kernel_work(kernel, flops, nbytes)``)."""
    for counter in _active:
        counter.kernel_work(kernel, flops, nbytes)


@contextlib.contextmanager
def host(kernel: str, flops: int, nbytes: int):
    """A host call of ``kernel``'s plain version: its kernel's work charged,
    and, where a counter is active, the block's operators hidden from the
    dispatch modes (the counters see the kernel, as on the card)."""
    charge(kernel, flops, nbytes)
    if not _active:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield


@contextlib.contextmanager
def counting(counter):
    """Make ``counter`` active for the block."""
    _active.append(counter)
    try:
        yield counter
    finally:
        _active.remove(counter)


def trip_scale() -> int:
    """The trips the running body stands for (module note)."""
    return _scale


def trips(n: int):
    """The indices of a loop of ``n`` identical trips (module note)."""
    global _scale
    tripping = [c for c in _active if getattr(c, "counts_trips", False)]
    if not tripping or n <= 1:
        yield from range(n)
        return
    for c in tripping:
        c.scale *= n
    _scale *= n
    try:
        yield 0
    finally:
        _scale //= n
        for c in tripping:
            c.scale //= n
