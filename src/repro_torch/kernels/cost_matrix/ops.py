"""Wrappers of the cost_matrix CUDA kernels (paper §IV/§V).

A tensor on the host goes to the plain version in ``ref.py``; a CUDA
tensor launches the kernel (``csrc/cost_matrix.cu``) or raises. No
padding: the kernels mask their ragged tiles. Every entry also gets a
scratch buffer for the per-site terms that a pre-pass launched by the
same C entry computes (``scratch_floats``; ``scratch_doubles`` also
holds the float64 fix-up pass's row flags). Each wrapper counts its
kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import cost_argmin_f64_ref, cost_matrix_f32_ref, cost_matrix_f64_ref, site_rows_f32

__all__ = ["cost_matrix", "cost_matrix_classed", "cost_matrix_f64", "cost_argmin_f64",
           "argmin_f64_unchecked", "scratch_doubles", "scratch_floats"]

_F32, _F64 = torch.float32, torch.float64
_F32_FIELDS = 7


def scratch_floats(S: int) -> int:
    """Float32 words of the f32 kernel's scratch (``csrc/cost_matrix.cu``):
    seven per-site arrays of S — net, eff, comp_site, cap, RN(1/eff),
    RN(1/cap) and the column flags."""
    return _F32_FIELDS * S


def cost_matrix(job_bytes, job_work, cap, queue, work, load, bw, loss, rtt, alive):
    """§IV cost over (J, S) + per-job best site: ``cost_matrix_classed``
    with all-ones class masks (net + comp + dtc). Returns (cost, best)."""
    ones = torch.ones_like(job_bytes)
    return cost_matrix_classed(
        job_bytes, job_work, ones, ones, cap, queue, work, load, bw, loss, rtt, alive
    )


def cost_matrix_classed(
    job_bytes, job_work, job_wcomp, job_wdtc,
    cap, queue, work, load, bw, loss, rtt, alive, mss=1460.0,
    *, w_queue=1.0, w_work=1.0, w_load=1.0,
):
    """Float32 §V per-class cost over (J, S), the TPU kernel's function:
    net + wcomp·comp + wdtc·dtc, dead columns 3e38. Job columns are
    (J,) float32, site columns (S,) float32, ``alive`` (S,) bool, ``mss``
    a float or an (S,) float32 tensor. Returns (cost (J, S) float32,
    best (J,) int32 — first index wins ties)."""
    J, S = job_bytes.shape[0], cap.shape[0]
    if not isinstance(mss, torch.Tensor):
        mss = torch.full((S,), float(mss), dtype=_F32, device=cap.device)
    jobs = dict(job_bytes=job_bytes, job_work=job_work, job_wcomp=job_wcomp, job_wdtc=job_wdtc)
    sites = dict(cap=cap, queue=queue, work=work, load=load, bw=bw, loss=loss, rtt=rtt, mss=mss)
    args = {**jobs, **sites, "alive": alive}
    dtypes = {k: _F32 for k in args}
    dtypes["alive"] = torch.bool
    shapes = {**{k: (J,) for k in jobs}, **{k: (S,) for k in sites}, "alive": (S,)}
    dev = _build.launch_device("cost_matrix_classed", args, dtypes, shapes)
    rows = site_rows_f32(cap, queue, work, load, bw, loss, rtt, alive, mss)
    if dev.type == "cpu":
        cost = cost_matrix_f32_ref(
            job_bytes, job_work, job_wcomp, job_wdtc, rows, w_queue, w_work, w_load
        )
    else:
        cost = torch.empty((J, S), dtype=_F32, device=dev)
        if cost.numel():
            lib = _build.library()
            cost_matrix_classed.launches += 1
            scratch = torch.empty(scratch_floats(S), dtype=_F32, device=dev)
            rc = lib.repro_cost_matrix_f32(
                job_bytes.data_ptr(), job_work.data_ptr(), job_wcomp.data_ptr(),
                job_wdtc.data_ptr(), rows.data_ptr(), cost.data_ptr(), J, S,
                w_queue, w_work, w_load, scratch.data_ptr(), _build.stream_of(dev),
            )
            _build.check(rc, "cost_matrix_classed")
    return cost, torch.argmin(cost, dim=1).to(torch.int32)


cost_matrix_classed.launches = 0


_MAX_SITES = 2**30   # the f64 kernels index columns with 32-bit ints
_LANES, _TERM_FIELDS, _GATE_SLOTS = 32, 11, 256


def scratch_doubles(S: int, J: int) -> int:
    """Float64 words of the f64 kernels' scratch (``csrc/cost_matrix.cu``):
    eleven per-site term arrays over S rounded up to 32 columns, 256
    int32 partial gates, 256 int32 partial column flags, then J int32
    row flags for the fix-up pass."""
    return _TERM_FIELDS * (-(-S // _LANES) * _LANES) + _GATE_SLOTS + -(-J // 2)


def _f64_args(name, bytes_, work, cls, rows, alive):
    J, S = bytes_.shape[0], alive.shape[0]
    if S > _MAX_SITES:
        raise ValueError(f"{name}: {S} sites exceed the kernels' 32-bit column index ({_MAX_SITES})")
    return J, S, _build.launch_device(
        name,
        dict(bytes_=bytes_, work=work, cls=cls, rows=rows, alive=alive),
        dict(bytes_=_F64, work=_F64, cls=torch.int8, rows=_F64, alive=torch.bool),
        dict(bytes_=(J,), work=(J,), cls=(J,), rows=(8, S), alive=(S,)),
    )


def cost_matrix_f64(
    bytes_, work, cls, rows, alive,
    *, w_queue=1.0, w_work=1.0, w_load=1.0, mask_dead=True,
):
    """Float64 per-class (J, S) plane in ``class_total`` order, equal to
    the reference's NumPy plane bit for bit. ``bytes_``/``work`` (J,)
    float64, ``cls`` (J,) int8 (0 COMPUTE, 1 DATA, 2 BOTH), ``rows``
    (8, S) float64 in PACK_FIELDS order, ``alive`` (S,) bool."""
    J, S, dev = _f64_args("cost_matrix_f64", bytes_, work, cls, rows, alive)
    if dev.type == "cpu":
        return cost_matrix_f64_ref(
            bytes_, work, cls, rows, alive, w_queue, w_work, w_load, mask_dead
        )
    cost = torch.empty((J, S), dtype=_F64, device=dev)
    if cost.numel():
        lib = _build.library()
        cost_matrix_f64.launches += 1
        scratch = torch.empty(scratch_doubles(S, J), dtype=_F64, device=dev)
        rc = lib.repro_cost_matrix_f64(
            bytes_.data_ptr(), work.data_ptr(), cls.data_ptr(), rows.data_ptr(),
            alive.data_ptr(), cost.data_ptr(), J, S, w_queue, w_work, w_load,
            int(bool(mask_dead)), scratch.data_ptr(), _build.stream_of(dev),
        )
        _build.check(rc, "cost_matrix_f64")
    return cost


cost_matrix_f64.launches = 0


def cost_argmin_f64(bytes_, work, cls, rows, alive, *, w_queue=1.0, w_work=1.0, w_load=1.0):
    """Per-job cheapest alive site over the float64 plane of
    ``cost_matrix_f64`` (dead columns masked), without writing the
    plane on the card. Returns (best (J,) int64, cost (J,) float64);
    first index wins ties, a NaN counts as the minimum. Raises
    ``RuntimeError("no alive site available")`` when a picked cost is
    not finite."""
    best, cost = argmin_f64_unchecked(
        bytes_, work, cls, rows, alive, w_queue=w_queue, w_work=w_work, w_load=w_load
    )
    if not bool(torch.isfinite(cost).all()):
        raise RuntimeError("no alive site available")
    return best, cost


def argmin_f64_unchecked(bytes_, work, cls, rows, alive, *, w_queue=1.0, w_work=1.0, w_load=1.0):
    """``cost_argmin_f64`` without the finite check: a NaN or +inf pick
    (an all-dead row) is returned as it is, for the checks that hold the
    kernel to its plain version on such rows. Counts its launches on
    ``cost_argmin_f64``."""
    J, S, dev = _f64_args("cost_argmin_f64", bytes_, work, cls, rows, alive)
    if J and not S:
        raise RuntimeError("no alive site available")
    if dev.type == "cpu":
        return cost_argmin_f64_ref(bytes_, work, cls, rows, alive, w_queue, w_work, w_load)
    best = torch.empty(J, dtype=torch.int64, device=dev)
    cost = torch.empty(J, dtype=_F64, device=dev)
    if J:
        lib = _build.library()
        cost_argmin_f64.launches += 1
        scratch = torch.empty(scratch_doubles(S, J), dtype=_F64, device=dev)
        rc = lib.repro_cost_argmin_f64(
            bytes_.data_ptr(), work.data_ptr(), cls.data_ptr(), rows.data_ptr(),
            alive.data_ptr(), best.data_ptr(), cost.data_ptr(), J, S,
            w_queue, w_work, w_load, scratch.data_ptr(), _build.stream_of(dev),
        )
        _build.check(rc, "cost_argmin_f64")
    return best, cost


cost_argmin_f64.launches = 0
