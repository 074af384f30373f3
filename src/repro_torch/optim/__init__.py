"""Optimizer (port of ``src/repro/optim``): AdamW and learning-rate
schedules.  Int8 error-feedback gradient compression
(``optim/grad_compress.py``) is not ported yet (ROADMAP.md, Queue A item
12b)."""

from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from .schedules import constant_schedule, cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
    "constant_schedule", "cosine_schedule", "linear_warmup_cosine",
]
