"""Model zoo, ported: the dense family (gemma2, gemma3, nemotron,
mistral) with prefill, KV-cache decode and the two attention kernels.
The other families are later slices (ROADMAP.md, queue A12)."""
from .common import ModelConfig, layer_flags
from .lm import LM
from . import decode
from .interop import params_from_reference

__all__ = ["ModelConfig", "layer_flags", "LM", "decode", "params_from_reference"]
