"""Assigned input shapes × architectures: the 40-cell grid (the port of
``repro.configs.shapes``).

  train_4k     seq 4096,   global_batch 256   (training     → train_step)
  prefill_32k  seq 32768,  global_batch 32    (inference    → prefill_step)
  decode_32k   seq 32768,  global_batch 128   (decode       → serve_step)
  long_500k    seq 524288, global_batch 1     (long decode  → serve_step)

long_500k runs only for sub-quadratic / mostly-local archs; pure
full-attention archs are N/A. ``input_specs`` returns tensors on the
``meta`` device only (shapes and types, no storage); the modality
frontends are stubs supplying precomputed embeddings.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.common import ModelConfig

__all__ = ["SHAPES", "Shape", "long_500k_applicable", "cells", "input_specs",
           "WHISPER_DECODER_LEN"]


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

# sub-quadratic (SSM / hybrid) or mostly-local (sliding-window) archs
_LONG_OK = {"mamba2-780m", "recurrentgemma-2b", "gemma3-12b", "gemma2-9b"}

WHISPER_DECODER_LEN = 448  # whisper's max target length


def long_500k_applicable(arch: str) -> bool:
    return arch in _LONG_OK


def cells(archs: list[str]) -> list[tuple[str, str, bool]]:
    """All 40 (arch, shape, runnable) cells."""
    out = []
    for a in archs:
        for s in SHAPES:
            runnable = s != "long_500k" or long_500k_applicable(a)
            out.append((a, s, runnable))
    return out


def input_specs(cfg: ModelConfig, shape: str | Shape) -> dict:
    """``meta`` stand-ins for every model input of this cell: int32
    tokens (and labels), the compute type for image and audio embeddings.
    ``shape`` is a name of ``SHAPES`` or a ``Shape`` of one's own (a cell
    cut to one card).

    train/prefill → the batch for ``LM.loss``/``LM.forward``; decode → the
    tokens of one ``decode_step`` (the cache comes from
    ``runtime.serve.abstract_cache``).
    """
    sh = shape if isinstance(shape, Shape) else SHAPES[shape]
    B, S = sh.global_batch, sh.seq_len
    f = cfg.cdtype
    d = cfg.d_model

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.family == "encdec":
        # seq_len is the (stub) audio-frame length; decoder is short.
        T = WHISPER_DECODER_LEN
        if sh.kind == "train":
            return {"tokens": meta(B, T), "labels": meta(B, T), "audio_embeds": meta(B, S, d, dtype=f)}
        if sh.kind == "prefill":
            return {"tokens": meta(B, T), "audio_embeds": meta(B, S, d, dtype=f)}
        return {"tokens": meta(B, 1), "audio_embeds": meta(B, S, d, dtype=f)}

    extra = {}
    if cfg.family == "vlm":
        extra["image_embeds"] = meta(B, cfg.num_image_tokens, d, dtype=f)

    if sh.kind == "train":
        return {"tokens": meta(B, S), "labels": meta(B, S), **extra}
    if sh.kind == "prefill":
        return {"tokens": meta(B, S), **extra}
    return {"tokens": meta(B, 1), **extra}
