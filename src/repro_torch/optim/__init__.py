"""Optimizer of the port (mirrors :mod:`repro.optim`): decoupled AdamW with
f32 moments and the cosine learning-rate schedule."""

from .adamw import AdamWState, adamw_init, adamw_update, global_norm
from .schedules import cosine_schedule, linear_warmup

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "linear_warmup"]
