"""Learning-rate schedules (port of ``repro.optim.schedule``).

Pure functions of the step counter. Each returns a Python float holding an
f32 value, computed in f32 in the reference's op order (numpy float32
scalars stand in for its 0-dim ``jnp.float32`` arrays), so the optimizer
sees the same learning rate. ``linear_warmup_cosine`` gives lr = 0 at
step 0.
"""
from __future__ import annotations

import numpy as np

__all__ = ["constant", "linear_warmup_linear_decay", "step_decay",
           "cosine_decay", "linear_warmup_cosine"]

_F = np.float32


def constant(lr: float):
    return lambda step: float(_F(lr))


def step_decay(lr: float, boundaries: tuple[int, ...], factor: float = 0.1):
    """Piecewise-constant decay (paper's ResNet schedules)."""
    bs = np.asarray(boundaries)

    def f(step):
        n = int(np.sum(int(step) >= bs))
        return float(_F(lr) * _F(factor) ** _F(n))
    return f


def linear_warmup_linear_decay(peak: float, warmup: int, total: int):
    """Paper's BERT schedule: linear warmup to ``peak`` then linear → 0."""
    def f(step):
        s = _F(step)
        w = _F(max(warmup, 1))
        up = _F(peak) * s / w
        down = _F(peak) * max(_F(0.0), (_F(total) - s) / _F(max(total - warmup, 1)))
        return float(up if s < warmup else down)
    return f


def cosine_decay(peak: float, total: int, floor: float = 0.0):
    def f(step):
        frac = min(max(_F(step) / _F(max(total, 1)), _F(0.0)), _F(1.0))
        half_span = _F(0.5 * (peak - floor))
        return float(_F(floor) + half_span * (_F(1.0) + np.cos(_F(np.pi) * frac)))
    return f


def linear_warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    cos = cosine_decay(peak, max(total - warmup, 1), floor)

    def f(step):
        s = _F(step)
        if s < warmup:
            return float(_F(peak) * s / _F(max(warmup, 1)))
        return cos(s - _F(warmup))
    return f
