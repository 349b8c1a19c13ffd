"""Learning-rate schedules (mirrors :mod:`repro.optim.schedules`): pure
functions of the step, computed in float32 as the reference computes them,
returned as 0-d float32 CPU tensors."""

from __future__ import annotations

import math

import torch

__all__ = ["linear_warmup", "cosine_schedule"]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).reshape(()).cpu()


def linear_warmup(step, peak_lr: float, warmup_steps: int) -> torch.Tensor:
    s = _f32(step)
    return peak_lr * torch.clamp_max((s + 1) / max(warmup_steps, 1), 1.0)


def cosine_schedule(step, peak_lr: float, warmup_steps: int,
                    total_steps: int, final_frac: float = 0.1
                    ) -> torch.Tensor:
    s = _f32(step)
    warm = linear_warmup(step, peak_lr, warmup_steps)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps,
                                                1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(
        _f32(math.pi) * prog))
    return torch.where(s < warmup_steps, warm, peak_lr * cos)
