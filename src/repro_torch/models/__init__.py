"""Model zoo, ported: the dense (gemma2, gemma3, nemotron, mistral),
vlm (llama-3.2-vision), moe (deepseek-v2/v3: MLA attention and routed
experts), ssm (mamba2), hybrid (recurrentgemma) and encdec (whisper)
families, with prefill, cache decode, the training loss (``LM.loss``)
and the two attention kernels (flash attention with its backward). The
sharded decode paths are a later slice (ROADMAP.md, queue A12)."""
from .common import ModelConfig, layer_flags
from .lm import LM
from . import decode
from .interop import opt_state_from_reference, params_from_reference

__all__ = ["ModelConfig", "layer_flags", "LM", "decode", "params_from_reference", "opt_state_from_reference"]
