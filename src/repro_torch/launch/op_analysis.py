"""Op-level cost of one eager step: the torch twin of
``repro.launch.hlo_analysis``.

The reference parses compiled XLA HLO; torch has no such artifact, but
an eager step is a sequence of aten operators, which a
``TorchDispatchMode`` sees one by one, on the card or on the ``meta``
device alike. ``OpAnalysis`` counts over the block it is entered for:

  flops            — ``torch.utils.flop_counter``'s registered formulas
                     (mm, addmm, bmm, baddbmm, convolutions, attention
                     ops) over every operator, plus the FLOPs the
                     attention kernels charge (``kernels._work``: a
                     kernel launch is a ctypes call no mode sees; on
                     the host their plain versions run hidden from the
                     mode, ``_counting.host``)
  hbm_bytes        — operand and result bytes of every operator that
                     moves data (view and allocation operators move none;
                     an indexing operator streams only the rows it
                     touches, so its large operands count at the
                     result's size), plus the kernels' charged bytes.
                     Eager PyTorch fuses nothing: this is the eager
                     program's traffic, where XLA's count is the fused
                     program's
  score_hbm_bytes  — the part of hbm_bytes of operators whose result is
                     score-shaped (…, S, S) with S ≥ 1024, outside a kernel
  top_hbm          — the 10 operators with the most bytes
  peak_bytes       — the high-water mark of live storage the block
                     created: a storage's bytes count from the operator
                     that creates it until it is freed (storages that
                     existed before the block do not count), the stand-in
                     for ``memory_analysis().temp_size_in_bytes``

A collective (a ``c10d`` operator, on a placed mesh or on the ``fake``
backend of a ``meta`` rank) is an operator like any other here: its
buffers count as HBM bytes, as the reference adds a collective's operands
and result to its ``hbm_bytes``. The bytes a rank receives over the links
are not counted here but by ``launch.mesh.received``, which the dry run
zeroes and reads around the step.

``by_kernel`` counts each kernel's charged calls, FLOPs and bytes, and
``aten_flops``/``aten_bytes`` the operators' part alone. Field names are
``HloCost``'s where they mean the same thing.

``OpAnalysis(trips=True)`` also counts ``_counting.trips`` loops (the
training step's microbatches) trip-count-aware: one trip runs, its
counts scaled by the number of trips, as ``hlo_analysis`` multiplies a
``while`` body. The values of such a run are wrong (one microbatch's
gradients stand for all), so it refuses any operator that gives a
tensor with elements off the ``meta`` device (``torch.utils.checkpoint``
makes an empty host tensor); the high-water mark is that of one trip,
which the loop repeats.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .. import _counting

__all__ = ["OpAnalysis", "OpCost"]

_aten = torch.ops.aten
# Operators that allocate or relabel storage without moving data.
_NO_TRAFFIC = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.empty_like.default, _aten.detach.default,
    _aten.lift_fresh.default,
}
# Indexing operators: only the touched rows of a large operand stream.
_SLICE_LIKE = {
    _aten.embedding.default, _aten.index.Tensor, _aten.index_select.default, _aten.gather.default,
    _aten.index_put_.default, _aten.index_put.default, _aten.scatter.src, _aten.scatter_.src,
}


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _score_like(t: torch.Tensor) -> bool:
    """An attention-score-shaped result (…, S, S), S ≥ 1024."""
    return t.dim() >= 2 and t.shape[-1] == t.shape[-2] and t.shape[-1] >= 1024


@dataclass
class OpCost:
    flops: int = 0
    hbm_bytes: int = 0
    score_hbm_bytes: int = 0
    top_hbm: list = field(default_factory=list)
    peak_bytes: int = 0
    aten_flops: int = 0
    aten_bytes: int = 0
    ops: int = 0
    by_kernel: dict = field(default_factory=dict)


class OpAnalysis(TorchDispatchMode):
    """Count one block's operators (module note). Use as a context; the
    result is ``self.cost`` (an ``OpCost``) once the block has ended."""

    def __init__(self, top: int = 10, trips: bool = False):
        super().__init__()
        self.cost = OpCost()
        self.counts_trips = trips
        self.scale = 1          # the enclosing trips' count (``_counting.trips``)
        self._top = top
        self._live: dict[int, int] = {}     # storage key → bytes, created in the block
        self._now = 0
        self._hbm: list[tuple[float, str]] = []
        self._kernels = _counting.counting(self)

    def __enter__(self):
        self._kernels.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._kernels.__exit__(*exc)
            self._hbm.sort(key=lambda t: -t[0])
            self.cost.top_hbm = self._hbm[: self._top]

    # -- the kernels' charges (kernels._work) ----------------------------------
    def kernel_work(self, kernel: str, flops: int, nbytes: int) -> None:
        c = self.cost
        flops, nbytes = flops * self.scale, nbytes * self.scale
        c.flops += flops
        c.hbm_bytes += nbytes
        rec = c.by_kernel.setdefault(kernel, {"calls": 0, "flops": 0, "bytes": 0})
        rec["calls"] += self.scale
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self._hbm.append((float(nbytes), f"kernel {kernel}"))

    # -- storage lifetimes --------------------------------------------------------
    def _freed(self, key: int) -> None:
        self._now -= self._live.pop(key, 0)

    def _track(self, outs, ins) -> None:
        """Count the storages an operator created: its outputs' storages
        that are none of its inputs' (a view or an in-place result shares
        an input's storage, which may predate the block)."""
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in seen:
                continue
            n = st.nbytes()
            self._live[key] = n
            self._now += n
            weakref.finalize(st, self._freed, key)
        if self._now > self.cost.peak_bytes:
            self.cost.peak_bytes = self._now

    # -- operators ----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c, k = self.cost, self.scale
        c.ops += k
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        if self.counts_trips and any(t.device.type != "meta" and t.numel() for t in outs):
            raise RuntimeError(f"OpAnalysis(trips=True) counts only meta programs (one trip stands for all): "
                               f"{func} gave a tensor on {[str(t.device) for t in outs]}")
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out) * k
            c.flops += f
            c.aten_flops += f
        self._track(outs, ins)
        if func.is_view or func in _NO_TRAFFIC:
            return out
        rb = sum(_tensor_bytes(t) for t in outs)
        if func in _SLICE_LIKE:
            nb = rb + sum(min(_tensor_bytes(t), rb) for t in ins)
        else:
            nb = rb + sum(_tensor_bytes(t) for t in ins)
        nb *= k
        c.hbm_bytes += nb
        c.aten_bytes += nb
        if any(_score_like(t) for t in outs):
            c.score_hbm_bytes += nb
        shape = tuple(outs[0].shape) if outs else ()
        self._hbm.append((float(nb), f"{func} -> {str(outs[0].dtype).removeprefix('torch.') if outs else ''}"
                                     f"{list(shape)}"))
        if len(self._hbm) > 4 * self._top + 64:
            self._hbm.sort(key=lambda t: -t[0])
            del self._hbm[2 * self._top:]
        return out

