"""Device resolution and the exact f64 helpers the bit-identical paths need.

Every entry point of the port takes ``device=None``, which means the
CUDA card: with no CUDA device that default raises instead of quietly
running on the host. Callers (the CPU tests among them) ask for the
host with ``device="cpu"``.

Two PyTorch habits break last-bit equality with the NumPy reference,
so the float64 paths avoid them:

* ``torch.sqrt`` on float64 CPU tensors is not correctly rounded on
  every build (AVX512 builds differ from ``np.sqrt`` in the last bit
  for about 0.8% of inputs); ``sqrt_rn`` takes NumPy's square root on
  the host and CUDA's, which is IEEE-exact, on the card.
* ``scalar / tensor`` is evaluated as ``tensor.reciprocal() * scalar``,
  and on CUDA ``tensor / scalar`` as a multiply by the reciprocal; both
  round twice. Exact quotients are always tensor / tensor.

One PyTorch habit breaks run-to-run equality on the host:

* the first vectorized transcendental (``torch.tanh``, ``torch.exp``)
  that an intra-op worker thread runs in a process can come out up to
  about 5e-5 off in relative terms, over that thread's whole share of
  the tensor, while every later call is exact to an ulp (torch 2.13
  CPU builds with MKL; about one process in five). ``warm_host_math``
  runs each such function once over enough elements to reach every
  intra-op thread and throws the result away; the host paths of
  ``models`` (attention, the MLPs, the RG-LRU and Mamba-2 blocks) and
  the attention kernels' plain versions call it before their first
  transcendental.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "sqrt_rn", "to_device", "to_host", "warm_host_math"]


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card (raises when there is none); anything
    else is passed to ``torch.device`` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA card by default and no CUDA "
                "device is available; pass device='cpu' to run on the host"
            )
        return torch.device("cuda")
    return torch.device(device)


def to_host(*cols: torch.Tensor) -> list[np.ndarray]:
    """Several same-length device columns (float64, int64 or bool) in one
    device → host copy: each rides as int64 bits and comes back as a
    NumPy array of its own dtype, every value exact."""
    block = torch.stack([
        c.view(torch.int64) if c.dtype == torch.float64 else c.to(torch.int64) for c in cols
    ]).cpu().numpy()
    out = []
    for c, row in zip(cols, block):
        if c.dtype == torch.float64:
            out.append(row.view(np.float64))
        elif c.dtype == torch.bool:
            out.append(row.astype(bool))
        else:
            out.append(row)
    return out


def to_device(dev, *arrays: np.ndarray) -> list[torch.Tensor]:
    """Host arrays of any lengths (float64, int64 or bool) in one host →
    device copy, each back in its own dtype, every value exact."""
    parts = [np.asarray(a, np.float64).view(np.int64) if np.asarray(a).dtype.kind == "f"
             else np.asarray(a, np.int64) for a in arrays]
    flat = torch.from_numpy(np.concatenate(parts) if parts else np.zeros(0, np.int64)).to(dev)
    out, off = [], 0
    for a, part in zip(arrays, parts):
        t = flat[off: off + len(part)]
        kind = np.asarray(a).dtype.kind
        out.append(t.view(torch.float64) if kind == "f" else t.to(torch.bool) if kind == "b" else t)
        off += len(part)
    return out


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded elementwise square root (see module note)."""
    if x.device.type == "cpu":
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


# Intra-op thread count the host math was last warmed for (0: never).
_warm_threads = 0


def warm_host_math(x: torch.Tensor) -> None:
    """Run the host's vectorized transcendentals once on every intra-op
    thread before ``x``'s first use (see module note); a no-op on the
    card and after the first call, unless the thread count grew."""
    global _warm_threads
    if x.device.type != "cpu":
        return
    threads = torch.get_num_threads()
    if threads <= _warm_threads:
        return
    # Each thread's share must clear the unary kernels' grain of 2,048.
    w = torch.linspace(-4.0, 4.0, max(1 << 21, threads << 16))
    for f in _WARM:
        f(w)
    _warm_threads = threads


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


# Every vectorized transcendental a host path calls: attention and the
# MLPs (tanh, exp, sin, cos, rsqrt, erf, sigmoid, tanh-GeLU, SiLU), the
# RG-LRU gates (sigmoid, softplus, exp, sqrt) and the Mamba-2 block
# (softplus, exp, SiLU, log1p inside softplus).
_WARM = (torch.tanh, torch.exp, torch.sin, torch.cos, torch.rsqrt, torch.erf, torch.sigmoid,
         torch.sqrt, torch.log1p, torch.nn.functional.softplus, torch.nn.functional.silu,
         _gelu_tanh)
