"""Learning-rate schedules: functions of the global step (one per local
iteration) returning a Python float, computed in float32 as the
reference computes them."""
from __future__ import annotations

import numpy as np


def constant(lr: float):
    return lambda step: float(np.float32(lr))


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        f32 = np.float32
        t = np.clip(f32(step) / f32(max(1, total_steps)), f32(0), f32(1))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t, dtype=f32))
        return float(f32(lr) * (f32(final_frac) + f32(1 - final_frac) * cos))
    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(lr, max(1, total_steps - warmup), final_frac)

    def fn(step):
        if step < warmup:
            return float(np.float32(lr) * np.float32(step)
                         / np.float32(max(1, warmup)))
        return cos(step - warmup)
    return fn
