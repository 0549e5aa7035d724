"""Wrappers of the flash_attention CUDA kernels, forward and backward.

Takes the model's layout, q (B, Sq, H, D) and k, v (B, Sk, KV, D), as the
reference wrapper ``repro.kernels.flash_attention.ops.flash_attention``
does; the kernel reads them through their strides, so nothing is
transposed. v may be narrower than q and k where the kernel has that
instance (``PAIRS``: MLA's 192-wide queries and keys against 128-wide
values); k and v then still share their strides, as two column ranges
of one buffer do. A tensor on the host goes to the plain version in
``ref.py``; a CUDA tensor launches the kernel (``csrc/flash_attention.cu``)
or raises. The wrapper counts its kernel launches in
``flash_attention.launches``, and per instance in
``flash_attention.by_pair[(D, Dv)]``. ``launcher`` builds the kernel's call on
checked CUDA tensors, for the wrapper and for timing it alone.

Head widths without an instance take the padded route on the card
(``instance``, ``pad_qkv``): the smallest instance of ``PAIRS`` at least
as wide on both sides runs on q, k and v with zero columns appended (k
and v two column ranges of one new buffer ``[k | 0 | v | 0]``) at the
true width's scale D^-0.5; zero columns add nothing to q·kᵀ and give
zero columns of o, dv, which are sliced off. ``by_pair`` keys the
instance launched, and ``flash_attention.padded`` counts the padded
calls. A width no instance covers (D > 256, or Dv wider than every
instance as wide as D) raises ``ValueError``.

With grad enabled and an input that requires grad, ``flash_attention``
goes through ``FlashAttentionFn``: its forward is the same launch (or
plain version), with the kernel also writing each row's log-sum-exp;
it saves q, k, v, o and that lse, and its backward is
``flash_attention_bwd`` — on a CUDA tensor the backward kernels
(``csrc/flash_attention_bwd.cu``, which take P from the forward's lse),
on a host tensor its plain version ``ref.flash_attention_bwd_ref``. A
failed build or launch raises in either direction. The backward counts
its launches in ``flash_attention_bwd.launches``,
``flash_attention_bwd.by_pair`` and ``flash_attention_bwd.padded``;
``bwd_launcher`` is its timing handle.

A ``meta`` tensor takes the card's route up to the launch, checks,
padding and output allocation included, and stops there: the outputs
(o, lse, dq, dk, dv) come back empty in the kernel's shapes and types,
and no launch or padded counter moves. On the card, on ``meta`` and on
the host alike a call charges its kernel's work, ``work``/``bwd_work`` at
the instance launched, to the active counters of
``repro_torch._counting`` (the dry run's ``launch.op_analysis``; the
host's plain version runs inside ``_counting.host``, hidden from them);
``visible_pairs`` is the (query, key)
pairs the masks let through, in closed form. ``launcher`` and
``bwd_launcher`` raise on anything but CUDA tensors.
"""
from __future__ import annotations

import math

import torch

from ... import _counting
from .. import _build
from .ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_bwd", "FlashAttentionFn", "launcher", "bwd_launcher",
           "instance", "pad_qkv", "visible_pairs", "work", "bwd_work", "HEAD_DIMS", "PAIRS"]

_ENTRY = {torch.float32: "repro_flash_attention_f32", torch.bfloat16: "repro_flash_attention_bf16"}
_BWD_ENTRY = {torch.float32: "repro_flash_attention_bwd_f32", torch.bfloat16: "repro_flash_attention_bwd_bf16"}
HEAD_DIMS = (32, 64, 128, 256)   # the kernel's instances with v as wide as q and k
PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)   # every (D, Dv) instance


def instance(D: int, Dv: int) -> tuple[int, int] | None:
    """The kernel instance (DQK, DV) that runs widths (D, Dv): the
    smallest of ``PAIRS`` with DQK ≥ D and DV ≥ Dv, or None."""
    fits = [p for p in PAIRS if p[0] >= D and p[1] >= Dv]
    return min(fits) if fits else None


def pad_qkv(q, k, v, pair: tuple[int, int]):
    """q, k, v with zero columns appended to the instance's widths
    (DQK, DV): q a new (B, Sq, H, DQK) tensor; k and v the two column
    ranges of one new (B, Sk, KV, DQK + DV) buffer ``[k | 0 | v | 0]``, so
    that they share their strides as the kernel requires."""
    DQK, DV = pair
    D, Dv = q.shape[-1], v.shape[-1]
    qp = q.new_zeros(q.shape[:-1] + (DQK,))
    qp[..., :D] = q
    buf = k.new_zeros(k.shape[:-1] + (DQK + DV,))
    buf[..., :D] = k
    buf[..., DQK:DQK + Dv] = v
    return qp, buf[..., :DQK], buf[..., DQK:]


def _tri(n: int) -> int:
    """1 + 2 + … + n, 0 for n ≤ 0."""
    return n * (n + 1) // 2 if n > 0 else 0


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks let through: query qp sees the keys
    kp ≤ min(qp, Sk − 1) (every key when not causal) with qp − kp < window
    when there is a window, that is min(qp + 1, Sk) keys (Sk) less the
    max(0, qp − window + 1) below its window, and none once that is
    negative (qp ≥ Sk + window − 1)."""
    m = min(Sq, Sk)
    seen = _tri(m) + (Sq - m) * Sk if causal else Sq * Sk
    if window > 0:
        seen += -_tri(Sq - window) + _tri(Sq - Sk - window)
    return seen


def work(B: int, Sq: int, Sk: int, H: int, KV: int, D: int, Dv: int, *, causal: bool = True, window: int = 0,
         itemsize: int = 2, lse: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one forward launch: two products a visible pair
    and head, 2·(D + Dv); q, k, v read once and o written once in their
    type, and the float32 lse written when asked for."""
    flops = 2 * B * H * visible_pairs(Sq, Sk, causal, window) * (D + Dv)
    nbytes = (B * Sq * H * (D + Dv) + B * Sk * KV * (D + Dv)) * itemsize + (4 * B * H * Sq if lse else 0)
    return flops, nbytes


def bwd_work(B: int, Sq: int, Sk: int, H: int, KV: int, D: int, Dv: int, *, causal: bool = True,
             window: int = 0, itemsize: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one backward launch: five products a visible
    pair and head (S, dP, dV, dQ, dK), 2·(3·D + 2·Dv); q, o, dO, k, v and
    the float32 lse read once, dq, dk, dv written once."""
    flops = 2 * (3 * D + 2 * Dv) * H * visible_pairs(Sq, Sk, causal, window) * B
    nbytes = (2 * B * Sq * H * (D + Dv) + 2 * B * Sk * KV * (D + Dv)) * itemsize + 4 * B * H * Sq
    return flops, nbytes


def _pad_cols(t, width: int):
    """t with zero columns appended to ``width`` (t itself when as wide)."""
    if t.shape[-1] == width:
        return t
    out = t.new_zeros(t.shape[:-1] + (width,))
    out[..., :t.shape[-1]] = t
    return out


def lse_stride(Sq: int) -> int:
    """Row stride of the kernels' (B, H, Sq) log-sum-exp and Δ buffers: Sq
    rounded up to 4 (``lse_stride`` in ``csrc/hopper.cuh``)."""
    return -(-Sq // 4) * 4


def _checked(q, k, v, window: int, softcap: float):
    """Validate a call's q, k, v and options; return (device, type)."""
    dev, dtype = _build.strided_device("flash_attention", dict(q=q, k=k, v=v), tuple(_ENTRY))
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention: q (B,Sq,H,D), k (B,Sk,KV,D) and v (B,Sk,KV,Dv); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != D or KV < 1 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "share B and D with H a multiple of KV")
    if window < 0 or softcap < 0:
        raise ValueError("flash_attention: window and softcap must be ≥ 0")
    if Sk < 1 or (window > 0 and Sq > Sk + window - 1):
        raise ValueError(f"flash_attention: a query row sees no key (Sq {Sq}, Sk {Sk}, window {window})")
    if dev.type != "cpu":           # the card's checks, on the card and on meta
        pair = instance(D, Dv)
        if pair is None:
            raise ValueError(f"flash_attention: the kernel takes D, Dv up to an instance of {PAIRS} "
                             f"(padded to the smallest that covers them), got {D}, {Dv}")
        if pair == (D, Dv):
            if k.stride() != v.stride():
                raise ValueError("flash_attention: k and v must have the same strides")
            _build.check_rows("flash_attention", dict(q=q, k=k, v=v))
    return dev, dtype


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0,
                    return_lse: bool = False):
    """q: (B, Sq, H, D); k: (B, Sk, KV, D); v: (B, Sk, KV, Dv) → (B, Sq, H, Dv),
    scores scaled by D^-0.5; with ``return_lse`` also each row's log-sum-exp
    (B, H, Sq) float32 of its scaled, capped, masked scores (no graph).

    Query and key positions are 0…Sq−1 and 0…Sk−1. Every query row must
    see at least one key (Sk ≥ 1, and Sq ≤ Sk + window − 1 with a
    window); the TPU kernel's answer for a row with none is the mean of
    all values, which no model path asks for. Differentiable: with grad
    enabled and an input that requires it, the call goes through
    ``FlashAttentionFn``."""
    _checked(q, k, v, window, softcap)
    if return_lse:
        return _forward(q, k, v, causal, window, softcap, lse=True)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, bool(causal), int(window), float(softcap))
    return _forward(q, k, v, causal, window, softcap)[0]


def _forward(q, k, v, causal, window, softcap, lse: bool = False):
    """The forward on checked tensors: the plain version on the host, the
    kernel (counted) on the card, empty outputs on ``meta``; returns
    (o, lse or None), lse (B, H, Sq) float32 when asked for (off the host a
    view of a (B, H, lse_stride(Sq)) buffer)."""
    B, Sq, H, D = q.shape
    Dv = v.shape[3]
    pair = instance(D, Dv)
    if q.device.type == "cpu":
        with _counting.host("flash_attention", *work(B, Sq, k.shape[1], H, k.shape[2], *(pair or (D, Dv)),
                                                     causal=causal, window=window, itemsize=q.element_size(),
                                                     lse=lse)):
            out = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap, return_lse=lse)
        return out if lse else (out, None)
    scale = 1.0 / math.sqrt(D)
    padded = pair != (D, Dv)
    if padded:
        q, k, v = pad_qkv(q, k, v, pair)
    o = torch.empty((B, Sq, H, pair[1]), dtype=q.dtype, device=q.device)
    lse_t = torch.empty((B, H, lse_stride(Sq)), dtype=torch.float32, device=q.device) if lse else None
    if B * Sq * H:
        _counting.charge("flash_attention", *work(B, Sq, k.shape[1], H, k.shape[2], *pair, causal=causal,
                                                  window=window, itemsize=q.element_size(), lse=lse))
        if q.device.type != "meta":
            run = launcher(q, k, v, o, lse=lse_t, causal=causal, window=window, softcap=softcap, scale=scale)
            flash_attention.launches += 1
            flash_attention.by_pair[pair] = flash_attention.by_pair.get(pair, 0) + 1
            flash_attention.padded += int(padded)
            run()
    if padded:
        o = o[..., :Dv].contiguous()
    return o, (lse_t[..., :Sq] if lse else None)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its backward: the forward kernel (or plain
    version) one way, ``flash_attention_bwd`` the other (on the card with
    the forward's log-sum-exp; the host rebuilds P with a softmax)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o, lse = _forward(q, k, v, causal, window, softcap, lse=q.device.type != "cpu")
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse=lse, **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True, window: int = 0, softcap: float = 0.0,
                        lse=None):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v, ...)`` = o at
    the output gradient do (B, Sq, H, Dv), in q's, k's and v's shapes and
    type: the backward kernels on the card, its plain version on the host,
    empty tensors on ``meta``.

    ``lse`` is the forward's row log-sum-exp (B, H, Sq) float32
    (``flash_attention(..., return_lse=True)``): the card's kernels take P
    from it, so it is required there and on ``meta``; the host's plain
    version rebuilds P without it."""
    dev, dtype = _checked(q, k, v, window, softcap)
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("o", o), ("do", do)):
        if not isinstance(t, torch.Tensor) or t.shape != (B, Sq, H, Dv) or t.device != dev:
            raise ValueError(f"flash_attention_bwd: {name} must be a ({B}, {Sq}, {H}, {Dv}) tensor on {dev}")
    if (lse is not None or dev.type != "cpu") and (not isinstance(lse, torch.Tensor) or lse.shape != (B, H, Sq)
                                                    or lse.device != dev):
        raise ValueError(f"flash_attention_bwd: lse must be a ({B}, {H}, {Sq}) tensor on {dev}")
    if dev.type == "cpu":
        with _counting.host("flash_attention_bwd", *bwd_work(B, Sq, Sk, H, KV, *(instance(D, Dv) or (D, Dv)),
                                                             causal=causal, window=window,
                                                             itemsize=q.element_size())):
            return flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window, softcap=softcap, lse=lse)
    ld = lse_stride(Sq)
    if lse.dtype != torch.float32 or lse.stride() != (H * ld, ld, 1):
        buf = torch.empty((B, H, ld), dtype=torch.float32, device=dev)
        buf[..., :Sq] = lse
        lse = buf[..., :Sq]
    pair = instance(D, Dv)
    padded = pair != (D, Dv)
    o, do = o.to(dtype).contiguous(), do.to(dtype).contiguous()
    if padded:
        q, k, v = pad_qkv(q, k, v, pair)
        o, do = _pad_cols(o, pair[1]), _pad_cols(do, pair[1])
    dq = torch.empty((B, Sq, H, pair[0]), dtype=dtype, device=dev)
    dk = torch.empty((B, Sk, KV, pair[0]), dtype=dtype, device=dev)
    dv = torch.empty((B, Sk, KV, pair[1]), dtype=dtype, device=dev)
    if B * Sq * H == 0:
        dk.zero_(), dv.zero_()
    else:
        _counting.charge("flash_attention_bwd", *bwd_work(B, Sq, Sk, H, KV, *pair, causal=causal,
                                                          window=window, itemsize=q.element_size()))
        if dev.type != "meta":
            run = bwd_launcher(q, k, v, o, do, dq, dk, dv, lse=lse, causal=causal, window=window,
                               softcap=softcap, scale=1.0 / math.sqrt(D))
            flash_attention_bwd.launches += 1
            flash_attention_bwd.by_pair[pair] = flash_attention_bwd.by_pair.get(pair, 0) + 1
            flash_attention_bwd.padded += int(padded)
            run()
    if padded:
        return dq[..., :D].contiguous(), dk[..., :D].contiguous(), dv[..., :Dv].contiguous()
    return dq, dk, dv


def launcher(q, k, v, o, *, lse=None, causal: bool = True, window: int = 0, softcap: float = 0.0,
             scale: float | None = None):
    """The kernel's launch into ``o`` (B, Sq, H, Dv) as a closure, on CUDA
    tensors that ``flash_attention`` has checked, at q's width (no
    padding); ``lse``, a float32 (B, H, lse_stride(Sq)) buffer or a view of
    its first Sq columns, also receives the rows' log-sum-exp. ``scale``
    defaults to D^-0.5 of q's width."""
    _build.require_card("flash_attention", q, k, v, o, lse)
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    fn = getattr(_build.library(), _ENTRY[q.dtype])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 0 if lse is None else lse.data_ptr(),
            B, H, KV, Sq, Sk, D, Dv, q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
            k.stride(2), int(bool(causal)), int(window), float(softcap), float(scale),
            _build.stream_of(q.device))

    def run(_hold=(q, k, v, o, lse)):
        _build.check(fn(*args), "flash_attention")
    return run


def bwd_launcher(q, k, v, o, do, dq, dk, dv, *, lse, causal: bool = True, window: int = 0,
                 softcap: float = 0.0, scale: float | None = None):
    """The backward kernels' launch (bf16: Δ, then kernel A: dq, kernel B:
    dk and dv; float32: kernel A: Δ and dq, kernel B) into dq, dk, dv as a
    closure, on CUDA tensors that ``flash_attention_bwd`` has checked, at
    q's width (o, do contiguous; lse the forward's, laid out as
    ``launcher`` writes it). ``scale`` defaults to D^-0.5 of q's width."""
    _build.require_card("flash_attention_bwd", q, k, v, o, do, dq, dk, dv, lse)
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    fn = getattr(_build.library(), _BWD_ENTRY[q.dtype])
    delta = torch.empty((B, H, lse_stride(Sq)), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), B, H, KV, Sq, Sk, D, Dv,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            int(bool(causal)), int(window), float(softcap), float(scale), _build.stream_of(q.device))

    def run(_hold=(q, k, v, o, do, dq, dk, dv, lse, delta)):
        _build.check(fn(*args), "flash_attention_bwd")
    return run


flash_attention.launches = 0
flash_attention.by_pair = {}
flash_attention.padded = 0
flash_attention_bwd.launches = 0
flash_attention_bwd.by_pair = {}
flash_attention_bwd.padded = 0
