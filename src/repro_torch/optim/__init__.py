"""Optimizer substrate (the port of ``repro.optim``): AdamW with float32
moments, its int8-moment variant, schedules, global-norm clipping and
error-feedback int8 gradient compression. Updates run in place under
``torch.no_grad()`` over a name → tensor dict of parameters
(``dict(lm.named_parameters())``) and a dict of their gradients."""
from .adamw import AdamWConfig, adamw_init, adamw_update, decays
from .schedule import cosine_schedule, linear_warmup_cosine
from .clip import clip_by_global_norm
from .compress import ef_int8_allreduce, quantize_int8, dequantize_int8

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "decays",
    "cosine_schedule", "linear_warmup_cosine", "clip_by_global_norm",
    "ef_int8_allreduce", "quantize_int8", "dequantize_int8",
]
