"""Optimizer (port of ``src/repro/optim``): AdamW, learning-rate
schedules and int8 error-feedback gradient compression."""

from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from .grad_compress import (
    CompressState,
    compress_decompress,
    compress_init,
    int8_dequantize,
    int8_quantize,
)
from .schedules import constant_schedule, cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
    "CompressState", "compress_decompress", "compress_init",
    "int8_dequantize", "int8_quantize",
    "constant_schedule", "cosine_schedule", "linear_warmup_cosine",
]
