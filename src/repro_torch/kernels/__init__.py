"""Hand-written CUDA kernels of the port, one package per TPU kernel of
the reference: ``ref.py`` (plain PyTorch), ``ops.py`` (wrapper and launch
counter) and ``csrc/*.cu``, built by ``_build``."""
