"""Least-squares regression — the paper's §3.1 theory-validation model
(port of ``repro.models.lstsq``).

The paper's synthetic setup: x ~ N(0, I_d), w* ~ U[0, 100)^d,
y = x·w* + N(0, 0.5²); batch-size-1 SGD; quantization applied exactly where
each theorem places it (weight updates vs forward/backward activations).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import jrandom
from repro_torch.core.formats import FloatFormat, round_nearest

__all__ = ["make_dataset", "lstsq_grad_quantized"]


def make_dataset(key, n: int = 1024, d: int = 10, noise: float = 0.5, device=None):
    """(X, y, w*) f32 on ``device`` (CUDA unless ``"cpu"``), the
    reference's draws from ``key`` (a :func:`repro_torch.core.jrandom.PRNGKey`,
    split in three as there): X and w* its bits, y = X·w* + noise·N(0, 1)
    computed in numpy f32 (``normal``'s last ulps aside, ROADMAP C20)."""
    kx, kw, kn = jrandom.split(key, 3)
    X = jrandom.normal(kx, (n, d))
    w_star = jrandom.uniform(kw, (d,), 0.0, 100.0)
    y = (X @ w_star + np.float32(noise) * jrandom.normal(kn, (n,))).astype(np.float32)
    dev = resolve_device(device)
    return tuple(torch.from_numpy(a).to(dev) for a in (X, y, w_star))


def lstsq_grad_quantized(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                         fmt: FloatFormat | None) -> torch.Tensor:
    """Sample gradient with the paper's fwd/bwd rounding placement:
    a = Q(x·w − y) (dot runs in the FMAC accumulator, one output rounding),
    g = Q(Q(a)·x). ``fmt=None`` ⇒ exact."""
    if fmt is None:
        return (x @ w - y) * x
    a = round_nearest(x @ w - y, fmt)       # activation rounding
    ga = round_nearest(a, fmt)              # activation-grad rounding
    return round_nearest(ga * x, fmt)       # weight-grad rounding
