"""Carry a reference model's parameters across.

``params_from_reference(cfg, tree)`` reads the tree the reference's
``LM.init`` returns, with every leaf already a NumPy array (it imports
nothing of the reference), and returns the port's ``state_dict`` for the
same model: ``LM(cfg, device=...).load_state_dict(...)`` then computes
what the reference computes. The reference stacks a family's blocks on
leading axes (``blocks`` over layers, ``self_blocks`` and ``rec_blocks``
over periods and then blocks within a period); the port keeps one module
a layer under the same name with those indices (``self_blocks.3.1.…``
is the reference's ``self_blocks[3, 1]``).

bfloat16 leaves come as NumPy arrays of the ``ml_dtypes`` bfloat16
type, which ``torch.from_numpy`` refuses; their bits are carried as
uint16 and viewed as ``torch.bfloat16``, so every value crosses exactly.

``opt_state_from_reference(cfg, opt_tree, optimizer)`` carries the
reference's optimizer state across by the same name map: AdamW's
float32 moments, adamw8's ``{q, scale}`` moments, and the step.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from .common import ModelConfig

__all__ = ["params_from_reference", "opt_state_from_reference", "tensor_from_numpy"]

# The reference's stacked subtrees and how many leading axes each stacks.
STACKED = {"blocks": 1, "self_blocks": 2, "cross_blocks": 1, "dense_blocks": 1, "moe_blocks": 1,
           "rec_blocks": 2, "attn_blocks": 1, "extra_rec": 1, "enc_blocks": 1, "dec_self": 1,
           "dec_cross": 1}


def tensor_from_numpy(a) -> torch.Tensor:
    """A CPU tensor with ``a``'s values and type, bfloat16 included."""
    a = np.array(a, order="C")                 # a C-ordered copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def params_from_reference(cfg: ModelConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The port's state dict from the reference's parameter tree of any
    family: top-level leaves (``embed``, ``final_norm``, ``unembed``,
    ``enc_norm``) as they are, and every leaf of a stacked subtree
    (``STACKED``) split along its stacking axes (the moe family's nested
    ``moe.shared`` leaves keep their path: ``moe_blocks.2.moe.shared.w_up``)."""
    out = {}
    for path, leaf in _leaves(tree):
        n = STACKED.get(path[0], 0)
        for idx in itertools.product(*(range(s) for s in leaf.shape[:n])):
            name = ".".join([path[0], *map(str, idx), *path[1:]])
            out[name] = tensor_from_numpy(leaf[idx])
    return out


def _qleaves(tree, prefix=()):
    """(path, {"q", "scale"}) of every adamw8 moment of a reference tree."""
    if set(tree) == {"q", "scale"}:
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _qleaves(v, prefix + (k,))


def opt_state_from_reference(cfg: ModelConfig, opt_tree: dict, optimizer: str = "adamw") -> dict:
    """The port's optimizer state (the ``optim.adamw_init`` /
    ``optim.adamw8.adamw8_init`` layout, keyed by parameter name) from the
    reference's ``{"m", "v", "step"}`` tree, every leaf a NumPy array.

    adamw8's codes tile each leaf's last axis, so a stacked leaf's codes
    split along the stacking axes like the leaf. A stacked scalar (a
    cross block's ``xgate``: one value a layer, the stack its only axis)
    is quantized across its layers in the reference and alone in the
    port: its moments are dequantized and requantized per layer."""
    from ..optim.adamw8 import _quantize

    if optimizer not in ("adamw", "adamw8"):
        raise ValueError(f"optimizer must be 'adamw' or 'adamw8', got {optimizer!r}")
    out = {"step": torch.tensor(int(np.asarray(opt_tree["step"])), dtype=torch.int64)}
    for moment in ("m", "v"):
        if optimizer == "adamw":
            out[moment] = params_from_reference(cfg, opt_tree[moment])
            continue
        state = {}
        for path, leaf in _qleaves(opt_tree[moment]):
            q, scale = np.asarray(leaf["q"]), np.asarray(leaf["scale"])
            n = STACKED.get(path[0], 0)
            if n and q.ndim == n + 1:                   # a stacked scalar: codes (..., nb, b)
                values = (q.astype(np.float32) * scale[..., None]).reshape(-1)
                stack = q.shape[:-2] + (q.shape[-2] * q.shape[-1],)
                for flat, idx in enumerate(itertools.product(*(range(s) for s in stack))):
                    name = ".".join([path[0], *map(str, idx), *path[1:]])
                    state[name] = _quantize(torch.from_numpy(values[flat: flat + 1]))
                continue
            for idx in itertools.product(*(range(s) for s in q.shape[:n])):
                name = ".".join([path[0], *map(str, idx), *path[1:]])
                state[name] = {"q": tensor_from_numpy(q[idx]), "scale": tensor_from_numpy(scale[idx])}
        out[moment] = state
    return out
