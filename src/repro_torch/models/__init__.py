"""Model zoo, ported: the dense (gemma2, gemma3, nemotron, mistral),
vlm (llama-3.2-vision), ssm (mamba2), hybrid (recurrentgemma) and encdec
(whisper) families, with prefill, cache decode and the two attention
kernels. The moe family (deepseek, MLA attention and routed experts) is
the next slice (ROADMAP.md, queue A12)."""
from .common import ModelConfig, layer_flags
from .lm import LM
from . import decode
from .interop import params_from_reference

__all__ = ["ModelConfig", "layer_flags", "LM", "decode", "params_from_reference"]
