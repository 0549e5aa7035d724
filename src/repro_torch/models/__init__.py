"""Model zoo, ported: the dense (gemma2, gemma3, nemotron, mistral),
vlm (llama-3.2-vision), moe (deepseek-v2/v3: MLA attention and routed
experts), ssm (mamba2), hybrid (recurrentgemma) and encdec (whisper)
families, with prefill, cache decode and the two attention kernels. The
sharded decode paths are a later slice (ROADMAP.md, queue A12)."""
from .common import ModelConfig, layer_flags
from .lm import LM
from . import decode
from .interop import params_from_reference

__all__ = ["ModelConfig", "layer_flags", "LM", "decode", "params_from_reference"]
