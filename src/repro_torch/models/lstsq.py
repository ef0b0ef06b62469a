"""Least-squares regression — the paper's §3.1 theory-validation model
(port of ``repro.models.lstsq``).

The paper's synthetic setup: x ~ N(0, I_d), w* ~ U[0, 100)^d,
y = x·w* + N(0, 0.5²); batch-size-1 SGD; quantization applied exactly where
each theorem places it (weight updates vs forward/backward activations).
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import FloatFormat, round_nearest

__all__ = ["make_dataset", "lstsq_grad_quantized"]


def make_dataset(gen: torch.Generator, n: int = 1024, d: int = 10, noise: float = 0.5):
    """(X, y, w*) on the generator's device. The draws come from ``gen``
    (a ``torch.Generator``) in place of the reference's JAX key, so they
    are the port's own: the same distributions, not the same numbers."""
    dev = gen.device
    X = torch.randn((n, d), generator=gen, device=dev, dtype=torch.float32)
    w_star = torch.rand((d,), generator=gen, device=dev, dtype=torch.float32) * 100.0
    y = X @ w_star + noise * torch.randn((n,), generator=gen, device=dev, dtype=torch.float32)
    return X, y, w_star


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
