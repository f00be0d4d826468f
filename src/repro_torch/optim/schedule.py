"""Learning-rate schedules as step -> lr callables: the port of
``repro.optim.schedule``. Each returns a 0-d f32 tensor; ``step`` is an
int or a tensor (an optimizer's count)."""
from __future__ import annotations

import math
from typing import Sequence

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    """lr times a half cosine from 1 to ``alpha`` over ``decay_steps``,
    then ``alpha``."""
    def f(step):
        t = torch.clamp(_f32(step) / max(decay_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * ((1 - alpha) * cos + alpha)
    return f


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                  alpha: float = 0.0):
    """A linear warm-up over ``warmup_steps``, then ``cosine_decay`` over
    the rest of ``decay_steps``."""
    cos = cosine_decay(lr, max(decay_steps - warmup_steps, 1), alpha)

    def f(step):
        step = _f32(step)
        warm = lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm,
                           cos(step - warmup_steps))
    return f


def step_decay(lr: float, boundaries: Sequence[int], factor: float = 0.1):
    """lr times ``factor`` to the number of boundaries at or below the
    step."""
    bs = torch.as_tensor(boundaries)

    def f(step):
        k = torch.sum(torch.as_tensor(step) >= bs)
        return _f32(lr * factor ** int(k))
    return f
