"""Carry a reference model's parameters across.

``params_from_reference(cfg, tree)`` reads the tree the reference's
``LM.init`` returns, with every leaf already a NumPy array (it imports
nothing of the reference), and returns the port's ``state_dict`` for the
same model: ``LM(cfg, device=...).load_state_dict(...)`` then computes
what the reference computes. The reference stacks the layers of
``blocks`` on a leading axis; the port keeps one block a layer.

bfloat16 leaves come as NumPy arrays of the ``ml_dtypes`` bfloat16
type, which ``torch.from_numpy`` refuses; their bits are carried as
uint16 and viewed as ``torch.bfloat16``, so every value crosses exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import ModelConfig

__all__ = ["params_from_reference", "tensor_from_numpy"]


def tensor_from_numpy(a) -> torch.Tensor:
    """A CPU tensor with ``a``'s values and type, bfloat16 included."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def params_from_reference(cfg: ModelConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The port's state dict from the reference's dense parameter tree
    (``embed``, ``final_norm``, optional ``unembed``, and ``blocks`` with
    ``ln1``, ``attn/{wq,wk,wv,wo[,q_norm,k_norm]}``, ``ln2``,
    ``mlp/{w_gate,w_up,w_down}`` stacked over layers)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"interop for the {cfg.family} family is not ported yet "
                                  "(ROADMAP.md, queue A12)")
    out = {"embed": tensor_from_numpy(tree["embed"]),
           "final_norm": tensor_from_numpy(tree["final_norm"])}
    if "unembed" in tree:
        out["unembed"] = tensor_from_numpy(tree["unembed"])
    blocks = tree["blocks"]
    for i in range(cfg.num_layers):
        out[f"blocks.{i}.ln1"] = tensor_from_numpy(np.asarray(blocks["ln1"])[i])
        out[f"blocks.{i}.ln2"] = tensor_from_numpy(np.asarray(blocks["ln2"])[i])
        for group in ("attn", "mlp"):
            for name, stacked in blocks[group].items():
                out[f"blocks.{i}.{group}.{name}"] = tensor_from_numpy(np.asarray(stacked)[i])
    return out
