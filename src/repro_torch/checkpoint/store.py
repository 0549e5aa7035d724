"""Checkpointing with async write and restore onto any device (the port
of ``repro.checkpoint.store``, with its on-disk layout).

Layout: <dir>/step_<n>/
    manifest.json        — tree structure, shapes, dtypes, step
    arrays.npz           — flattened leaves ``leaf_0``, ``leaf_1``, …
    COMMIT               — written last; a checkpoint without COMMIT is
                           torn and ignored (crash-safe)

A step is written under ``.tmp_step_<n>`` and renamed into place.
Trees are nested dicts (flattened in sorted-key order, the order
``jax.tree.flatten`` gives a dict), tuples and lists of tensors, so
``leaf_i`` is the same leaf in both packages for trees of the same
shape. npz cannot hold bfloat16 or float8: they are stored as their
uint16 / uint8 bits, with the logical dtype in the manifest, as the
reference stores them. Restore reads the leaves on the host and places
them on ``device`` (the reference's ``shardings``), each in its
``tree_like`` leaf's type.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "CheckpointManager"]

# logical dtype → (torch dtype, the unsigned type npz stores its bits as,
# the integer type of the same width that torch carries them through)
_EXOTIC = {
    "bfloat16": (torch.bfloat16, np.uint16, np.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8, np.uint8),
}
_CARRIER = {np.int16: torch.int16, np.uint8: torch.uint8}


def _encode(t) -> tuple[np.ndarray, str]:
    """A leaf as (npz-storable array, logical dtype name)."""
    if not isinstance(t, torch.Tensor):
        a = np.asarray(t)
        return a, str(a.dtype)
    t = t.detach().cpu().contiguous()
    logical = str(t.dtype).removeprefix("torch.")
    if logical in _EXOTIC:
        _, bits, carrier = _EXOTIC[logical]
        return t.view(_CARRIER[carrier]).numpy().view(bits), logical
    return t.numpy(), logical


def _decode(raw: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _EXOTIC:
        dtype, _, carrier = _EXOTIC[logical]
        return torch.from_numpy(np.array(raw).view(carrier)).view(dtype)
    return torch.from_numpy(np.array(raw))


def _flatten(tree) -> tuple[list, str]:
    """(leaves in jax.tree.flatten's order, a PyTreeDef-style description)."""
    leaves: list = []

    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in sorted(node)) + "}"
        if isinstance(node, (tuple, list)):
            inner = ", ".join(walk(x) for x in node)
            if isinstance(node, list):
                return f"[{inner}]"
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: None for k in node}
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(tree)


def save_checkpoint(directory: str | Path, step: int, tree, extra: Optional[dict] = None) -> Path:
    """Synchronous save (crash-safe via the COMMIT marker)."""
    directory = Path(directory)
    out = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, treedef = _flatten(tree)
    encoded = [_encode(leaf) for leaf in leaves]
    np.savez(tmp / "arrays.npz", **{f"leaf_{i}": raw for i, (raw, _) in enumerate(encoded)})
    manifest = {
        "step": step,
        "treedef": treedef,
        "num_leaves": len(leaves),
        "shapes": [list(raw.shape) for raw, _ in encoded],
        "dtypes": [logical for _, logical in encoded],
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "COMMIT").write_text("ok")
    if out.exists():
        shutil.rmtree(out)
    tmp.rename(out)
    return out


def _committed_steps(directory: Path) -> list[int]:
    if not directory.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                  if p.name.startswith("step_") and (p / "COMMIT").exists())


def restore_checkpoint(directory: str | Path, tree_like, step: Optional[int] = None,
                       device=None) -> tuple[Any, int]:
    """Restore the newest committed checkpoint (or ``step``) into the
    structure of ``tree_like``: each leaf in its like leaf's type, on
    ``device`` (the host when None)."""
    directory = Path(directory)
    steps = _committed_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint under {directory}")
    step = steps[-1] if step is None else step
    src = directory / f"step_{step:08d}"
    manifest = json.loads((src / "manifest.json").read_text())
    like, _ = _flatten(tree_like)
    if manifest["num_leaves"] != len(like):
        raise ValueError(f"{src} holds {manifest['num_leaves']} leaves, the tree has {len(like)}")
    loaded = []
    with np.load(src / "arrays.npz") as data:
        for i, ref in enumerate(like):
            t = _decode(data[f"leaf_{i}"], manifest["dtypes"][i])
            if isinstance(ref, torch.Tensor):
                t = t.to(ref.dtype)
            loaded.append(t.to(device) if device is not None else t)
    return _unflatten(tree_like, loaded), step


class CheckpointManager:
    """Async writer + retention; one in-flight save at a time (the
    training loop never blocks on I/O: the tree is copied to host tensors
    before the writer thread starts, then written off the step path)."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save_async(self, step: int, tree, extra: Optional[dict] = None) -> None:
        self.wait()
        leaves, _ = _flatten(tree)
        host_tree = _unflatten(tree, [t.detach().to("cpu", copy=True) if isinstance(t, torch.Tensor)
                                      else t for t in leaves])

        def _run():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except Exception as e:  # noqa: BLE001 — raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in _committed_steps(self.directory)[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = _committed_steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, tree_like, device=None):
        return restore_checkpoint(self.directory, tree_like, device=device)
