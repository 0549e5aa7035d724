"""Block-wise int8-quantized AdamW moments (``repro.optim.adamw8``).

Moments are stored int8 with one float32 scale per block. Blocks tile
the parameter's last axis (``block_size``: the largest divisor ≤ 256),
so each moment is ``{"q": int8 param.shape[:-1] + (nb, b), "scale":
float32 param.shape[:-1] + (nb,)}``; the second moment is stored as
√v. Codes round half to even (``torch.round``, as ``jnp.round``).

The reference stacks a family's layers into one leaf, so a scalar a
layer (a cross block's tanh gate, ``cross_blocks.<i>.xgate``) is one
(L,) leaf there, quantized in blocks of ``block_size(L)`` across its
layers. The port keeps one 0-d parameter a layer; ``stacked_scalars``
finds each such group (``adamw.stack_position``: the stacks of
``models.interop.STACKED``, in the reference's stacking order) and the
update quantizes the group as the reference quantizes its leaf. Each
member keeps the 0-d layout (q (1, 1), scale (1,)): its own code and
its block's scale.

A sharded step updates blocks of its parameters cut along the last axis
(``runtime.train``); ``last_dims`` gives the whole parameter's last
dimension, whose block size the codes keep, so that a rank's codes and
scales are its block of the whole leaf's.
"""
from __future__ import annotations

import itertools
import math

import torch

from .adamw import AdamWConfig, bias_corrections, decays, stack_position

__all__ = ["adamw8_init", "adamw8_update", "block_size", "stacked_scalars"]

_TARGET_BLOCK = 256


def block_size(last_dim: int) -> int:
    """Largest divisor of last_dim ≤ 256 (no padding, ever).

    When the dim is 16-divisible (i.e. potentially mesh-sharded) the
    block count nb = last_dim/b is kept 16-divisible too, so the
    quantized state shards exactly like the parameter."""
    cands = [b for b in range(min(_TARGET_BLOCK, last_dim), 0, -1)
             if last_dim % b == 0]
    if last_dim % 16 == 0 and last_dim >= 1024:   # mesh-shardable dims
        for b in cands:
            if (last_dim // b) % 16 == 0 and b >= 64:
                return b
        for b in cands:
            if (last_dim // b) % 16 == 0:
                return b
    return cands[0] if cands else 1


def _quantize(x32: torch.Tensor, b: int | None = None) -> dict:
    """param-shaped float32 → {q int8 (..., nb, b), scale float32 (..., nb)},
    in blocks of ``b`` (by default ``block_size`` of the last dimension)."""
    last = x32.shape[-1]
    b = block_size(last) if b is None else b
    xb = x32.reshape(x32.shape[:-1] + (last // b, b))
    scale = torch.clamp(torch.amax(torch.abs(xb), dim=-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _dequantize(m: dict, shape) -> torch.Tensor:
    return (m["q"].float() * m["scale"][..., None]).reshape(shape)


def _qshape(p: torch.Tensor) -> tuple:
    last = p.shape[-1] if p.dim() else 1
    b = block_size(max(last, 1))
    return tuple(p.shape[:-1]) + (max(last, 1) // b, b)


def stacked_scalars(params: dict) -> list[tuple[tuple[int, ...], list[str]]]:
    """The 0-d parameters the reference stacks into one leaf, grouped by
    leaf: (the leaf's shape, the names in its row-major order). A name
    ``<stack>.<i>[.<j>].<rest>`` belongs to the group ``(<stack>, <rest>)``
    at index (i[, j]) (``adamw.stack_position``)."""
    groups: dict[tuple, list] = {}
    for name, p in params.items():
        pos = stack_position(name)
        if p.dim() == 0 and pos is not None:
            groups.setdefault(pos[0], []).append((pos[1], name))
    out = []
    for members in groups.values():
        members.sort()
        shape = tuple(max(idx[a] for idx, _ in members) + 1 for a in range(len(members[0][0])))
        if math.prod(shape) != len(members):
            raise ValueError(f"adamw8: the stacked scalars {[n for _, n in members]} do not fill {shape}")
        out.append((shape, [n for _, n in members]))
    return out


def adamw8_init(params: dict) -> dict:
    def zeros(p):
        qshape = _qshape(p)
        return {"q": torch.zeros(qshape, dtype=torch.int8, device=p.device),
                "scale": torch.zeros(qshape[:-1], dtype=torch.float32, device=p.device)}

    dev = next(iter(params.values())).device if params else torch.device("cpu")
    return {
        "m": {n: zeros(p) for n, p in params.items()},
        "v": {n: zeros(p) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int64, device=dev),
    }


@torch.no_grad()
def adamw8_update(grads: dict, state: dict, params: dict, lr, cfg: AdamWConfig = AdamWConfig(),
                  last_dims: dict | None = None) -> dict:
    """One step in place: dequantize, the float32 AdamW update, requantize
    m and √v (in blocks of ``block_size(last_dims[name])`` where given);
    returns ``state``."""
    state["step"] += 1
    b1c, b2c = bias_corrections(state["step"], cfg)
    groups = stacked_scalars(params)
    grouped = {n for _, names in groups for n in names}
    for name, p in params.items():
        if name in grouped:
            continue
        shape = p.shape if p.dim() else (1,)
        g32 = grads[name].float().reshape(shape)
        mq, vq = state["m"][name], state["v"][name]
        m = cfg.b1 * _dequantize(mq, shape) + (1 - cfg.b1) * g32
        v = cfg.b2 * torch.square(_dequantize(vq, shape)) + (1 - cfg.b2) * torch.square(g32)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decays(name, p):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta.reshape(p.shape))
        b = block_size(last_dims[name]) if last_dims and name in last_dims else None
        for old, new in ((mq, _quantize(m, b)), (vq, _quantize(torch.sqrt(v), b))):
            old["q"].copy_(new["q"])
            old["scale"].copy_(new["scale"])
    for shape, names in groups:
        # the reference's stacked leaf: the same elementwise update and
        # codes in blocks across layers
        stack = lambda ts: torch.stack([t.reshape(()) for t in ts]).reshape(shape)  # noqa: E731
        g32 = stack([grads[n].float() for n in names])
        m = cfg.b1 * stack([_dequantize(state["m"][n], (1,)) for n in names]) + (1 - cfg.b1) * g32
        v = (cfg.b2 * torch.square(stack([_dequantize(state["v"][n], (1,)) for n in names]))
             + (1 - cfg.b2) * torch.square(g32))
        pf = stack([params[n].float() for n in names])
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decays(names[0], params[names[0]]):
            delta = delta + cfg.weight_decay * pf
        new_p = pf - lr * delta
        b = block_size(shape[-1])
        qm, qv = _quantize(m), _quantize(torch.sqrt(v))
        for idx, n in zip(itertools.product(*map(range, shape)), names):
            params[n].copy_(new_p[idx])
            code, blk = idx[:-1] + (idx[-1] // b, idx[-1] % b), idx[:-1] + (idx[-1] // b,)
            for mom, new in (("m", qm), ("v", qv)):
                state[mom][n]["q"].copy_(new["q"][code].reshape(1, 1))
                state[mom][n]["scale"].copy_(new["scale"][blk].reshape(1))
    return state
