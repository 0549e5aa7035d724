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
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from .common import ModelConfig

__all__ = ["params_from_reference", "tensor_from_numpy"]

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
