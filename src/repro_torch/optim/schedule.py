"""Learning-rate schedules (pure functions of the step).

Counterpart of ``repro.optim.schedule``: the step is an int or a tensor,
the result a 0-d f32 tensor computed in f32, as the JAX package computes
it under ``jit`` from an int32 step.
"""

from __future__ import annotations

import math

import torch

__all__ = ["linear_warmup", "cosine_schedule"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, warmup_steps: int, peak: float) -> torch.Tensor:
    return peak * torch.clamp((_f32(step) + 1) / max(1, warmup_steps),
                              max=1.0)


def cosine_schedule(step, *, peak: float, warmup_steps: int,
                    total_steps: int, floor: float = 0.0) -> torch.Tensor:
    s = _f32(step)
    warm = linear_warmup(s, warmup_steps, peak)
    t = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps),
                    0.0, 1.0)
    cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
    return torch.where(s < warmup_steps, warm, cos)
