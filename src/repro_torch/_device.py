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
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "sqrt_rn"]


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


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded elementwise square root (see module note)."""
    if x.device.type == "cpu":
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)
