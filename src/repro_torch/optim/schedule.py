"""Learning-rate schedules (functions of the int step): the port of
``repro.optim.schedule``.  The arithmetic is float32, as the JAX package's
is, and the result a Python float, so reading it never waits on the card."""
from __future__ import annotations

import math

import numpy as np


def make_schedule(kind: str, base_lr: float, warmup: int, total: int):
    f32 = np.float32

    def fn(step) -> float:
        step = f32(step)
        w = f32(warmup)
        warm = f32(base_lr) * min(step / f32(max(warmup, 1.0)), f32(1.0))
        frac = np.clip((step - w) / f32(max(total - warmup, 1.0)), f32(0.0),
                       f32(1.0))
        if kind == "cosine":
            decay = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * frac))
        elif kind == "linear":
            decay = f32(1.0) - frac
        else:
            decay = f32(1.0)
        return float(warm if step < w else f32(base_lr) * decay)
    return fn
