"""Wrapper of the decode_attention CUDA kernel.

Takes the model's layout, q (B, H, D) and a (B, S, KV, D) cache, as the
reference wrapper ``repro.kernels.decode_attention.ops.decode_attention``
does; the kernel reads the cache through its strides, so the transposed
copy the reference wrapper makes on every call is gone. A tensor on the
host goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel (``csrc/decode_attention.cu``: a split pass and a combine
pass, counted as one launch) or raises. The wrapper counts its launches
in ``decode_attention.launches``. ``launcher`` builds the kernel's call
on checked CUDA tensors, workspace included, for the wrapper and for
timing it alone. ``split_size`` chooses the keys a block of the split
pass takes from (B, KV, S) alone, and ``workspace_floats`` sizes the
workspace from it, so the launch and its workspace cannot disagree.

A head width without an instance takes the padded route on the card:
the smallest of ``HEAD_DIMS`` at least as wide runs on q and a copy of
the cache with zero columns appended (k and v two column ranges of one
new buffer ``[k | 0 | v | 0]``) at the true width's scale D^-0.5, and the
output's zero columns are sliced off; ``decode_attention.padded`` counts
those calls. D > 256 raises.

The key-range entry (``key0``, ``lse=True``): k and v are a range of a
longer cache whose key j sits at position key0 + j (pos may lie before
or past the range), and the call returns the range's float32 output
and the natural log-sum-exp of its visible scores (B, H), 0 and −inf
for a head that sees no key. Ranks holding ranges of one cache combine
those pairs (``models.attention.decode_attention_sharded``). A ring
cache's range takes pos' = min(pos, W − 1) and no window.

A ``meta`` tensor takes the card's route up to the launch (checks,
padding, the output's allocation) and stops there, returning an empty
output; no counter moves. On the card, on ``meta`` and on the host
alike a call charges its kernel's work (``work``, at the instance
launched) to the active counters of ``repro_torch._counting`` (the
host's plain version inside ``_counting.host``, hidden from them).
``launcher`` raises on
anything but CUDA tensors.
"""
from __future__ import annotations

import functools
import math

import torch

from ... import _counting
from .. import _build
from ..flash_attention.ops import pad_qkv
from .ref import decode_attention_ref

__all__ = ["decode_attention", "launcher", "split_size", "workspace_floats", "instance", "work", "visible_keys",
           "HEAD_DIMS",
           "MAX_REP", "CHUNK", "WAVE", "BLOCK_COST"]

_ENTRY = {torch.float32: "repro_decode_attention_f32", torch.bfloat16: "repro_decode_attention_bf16"}
HEAD_DIMS = (32, 64, 128, 256)   # the kernel's instances
MAX_REP = 16                     # query heads a kv group, at most
CHUNK = 32                       # keys a stage of the split pass streams
WAVE = 2 * 132                   # split-pass blocks an H100 holds at once (two an SM at bf16, D 256)
BLOCK_COST = 4 * CHUNK           # a block's fixed cost (pipeline fill, partial state), in keys


@functools.cache
def split_size(B: int, KV: int, S: int) -> int:
    """Keys a block of the split pass takes (a multiple of CHUNK).

    The pass streams the cache at the card's memory rate while every SM
    holds its blocks, so a wave of WAVE blocks takes about as long as one
    block: its keys plus BLOCK_COST. The number of splits n minimises
    ceil(B·KV·n / WAVE) · (ceil(S / n) + BLOCK_COST), the smallest n on a
    tie; chip_smoke.py's sweep over split sizes is the measurement."""
    best_n, best = 1, None
    for n in range(1, -(-S // CHUNK) + 1):
        cost = -(-B * KV * n // WAVE) * (-(-S // n) + BLOCK_COST)
        if best is None or cost < best:
            best_n, best = n, cost
    per = -(-S // best_n)
    return -(-per // CHUNK) * CHUNK


def instance(D: int) -> int | None:
    """The kernel instance that runs head width D: the smallest of
    ``HEAD_DIMS`` ≥ D, or None."""
    return min((d for d in HEAD_DIMS if d >= D), default=None)


def workspace_floats(B: int, KV: int, rep: int, S: int, D: int, split: int) -> int:
    """Floats of the split pass's workspace: m and l per (batch, group,
    split, head), then D accumulator values per (batch, group, split, head)."""
    return B * KV * -(-S // split) * rep * (D + 2)


def visible_keys(pos: int, *, window: int = 0, key0: int = 0, S: int | None = None) -> int:
    """Keys j of a range (key0 + j its position, j < S; no end without S)
    that the query at pos sees: key0 + j ≤ pos and, with a window,
    pos − (key0 + j) < window."""
    last = pos - key0 if S is None else min(S - 1, pos - key0)
    first = max(0, pos - key0 - window + 1) if window > 0 else 0
    return max(0, last - first + 1)


def work(B: int, H: int, KV: int, D: int, pos: int, *, window: int = 0, itemsize: int = 2, key0: int = 0,
         S: int | None = None, lse: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one launch: two products of 2·D a visible key
    (``visible_keys``) and head; those keys' k and v rows read once, q
    read once in its type, and o written once, in q's type or, with
    ``lse``, float32 with the float32 log-sum-exp (B, H)."""
    visible = visible_keys(pos, window=window, key0=key0, S=S)
    out = B * H * D * 4 + B * H * 4 if lse else B * H * D * itemsize
    return 4 * B * H * D * visible, (2 * B * visible * KV * D + B * H * D) * itemsize + out


def decode_attention(q, k, v, pos: int, *, window: int = 0, softcap: float = 0.0, key0: int = 0,
                     lse: bool = False):
    """q: (B, H, D); k, v: (B, S, KV, D); pos ≥ 0, key0 ≥ 0 → (B, H, D) in
    q's type, or with ``lse`` (out (B, H, D) float32, lse (B, H) float32).

    Key j sits at position key0 + j. Keys at positions kp ≤ pos (and
    pos − kp < window with a window) are visible to the one query token."""
    dev, dtype = _build.strided_device("decode_attention", dict(q=q, k=k, v=v), tuple(_ENTRY))
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q (B,H,D), k and v (B,S,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV < 1 or H % KV:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "share B and D with H a multiple of KV")
    pos, key0 = int(pos), int(key0)
    if pos < 0 or key0 < 0:
        raise ValueError(f"decode_attention: pos {pos} and key0 {key0} must be ≥ 0")
    if window < 0 or softcap < 0:
        raise ValueError("decode_attention: window and softcap must be ≥ 0")
    if dev.type == "cpu":
        with _counting.host("decode_attention", *work(B, H, KV, instance(D) or D, pos, window=window,
                                                      itemsize=q.element_size(), key0=key0, S=S, lse=lse)):
            return decode_attention_ref(q, k, v, pos, window=window, softcap=softcap, key0=key0, lse=lse)
    rep = H // KV
    Dk = instance(D)
    if Dk is None or rep > MAX_REP:
        raise ValueError(f"decode_attention: the kernel takes D up to an instance of {HEAD_DIMS} (padded "
                         f"to the smallest that covers it) and at most {MAX_REP} query heads a kv group, "
                         f"got D {D}, {rep}")
    padded = Dk != D
    if padded:
        q, k, v = pad_qkv(q, k, v, (Dk, Dk))
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    if k.stride() != v.stride():
        raise ValueError("decode_attention: k and v must have the same strides")
    _build.check_rows("decode_attention", dict(q=q, k=k, v=v))
    o = torch.empty((B, H, Dk), dtype=torch.float32 if lse else dtype, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev) if lse else None

    def result():
        out = o[..., :D].contiguous() if padded else o
        return (out, m) if lse else out

    if B == 0:
        return result()
    _counting.charge("decode_attention", *work(B, H, KV, Dk, pos, window=window, itemsize=q.element_size(),
                                               key0=key0, S=S, lse=lse))
    if dev.type == "meta":
        return result()
    run = launcher(q, k, v, o, pos, window=window, softcap=softcap, scale=1.0 / math.sqrt(D), key0=key0, lse=m)
    decode_attention.launches += 1
    decode_attention.padded += int(padded)
    decode_attention.ranged += int(lse)
    run()
    return result()


def launcher(q, k, v, o, pos: int, *, window: int = 0, softcap: float = 0.0, split: int | None = None,
             scale: float | None = None, key0: int = 0, lse=None):
    """The kernel's launch into ``o`` (B, H, D) as a closure, on CUDA
    tensors that ``decode_attention`` has checked, at q's width; the
    closure holds the split pass's float32 workspace (m, l, then acc per
    split and head). ``split`` overrides ``split_size`` (for measuring the
    choice); ``scale`` defaults to D^-0.5. With ``lse`` (a float32 (B, H)
    tensor) the kernel writes o in float32 and the log-sum-exp into it;
    key j of k and v sits at position key0 + j."""
    _build.require_card("decode_attention", q, k, v, o, lse)
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    split = split_size(B, KV, S) if split is None else split
    ws = torch.empty(workspace_floats(B, KV, rep, S, D, split), dtype=torch.float32, device=q.device)
    n = ws.numel() // (D + 2)
    fn = getattr(_build.library(), _ENTRY[q.dtype])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            ws.data_ptr(), ws[n:].data_ptr(), ws[2 * n:].data_ptr(), None if lse is None else lse.data_ptr(),
            B, KV, rep, S, D, int(pos), int(key0), k.stride(0), k.stride(1), k.stride(2),
            int(window), float(softcap), float(scale), split, _build.stream_of(q.device))

    def run(_hold=(q, k, v, o, ws, lse)):
        _build.check(fn(*args), "decode_attention")
    return run


decode_attention.launches = 0
decode_attention.padded = 0
decode_attention.ranged = 0      # launches of the key-range entry (lse=True)
