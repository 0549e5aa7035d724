"""PyTorch/CUDA port of the DIANA bulk scheduler.

A second package beside ``repro`` (the JAX reference), with the same
layout so every module has one twin: ``repro_torch.core.costs`` ↔
``repro.core.costs`` and so on. It imports ``torch`` and ``numpy``,
never ``jax`` and nothing of ``repro``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the TPU kernels of the reference are hand-written
CUDA C++ kernels here (``repro_torch.kernels``), built with ``nvcc`` at
first use.
"""
from ._device import resolve_device, sqrt_rn

__all__ = ["resolve_device", "sqrt_rn"]
