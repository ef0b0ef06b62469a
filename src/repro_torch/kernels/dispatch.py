"""Kernel dispatch context (port of ``repro.kernels.dispatch``).

A thread-local flag that lets an entry point (``make_serve_step``, a
bench, ``generate`` callers) route the serve step through the hand-written
kernels without threading a flag through every layer: single-token
attention through the decode kernels and, on CUDA, every op whose bits
could otherwise depend on the number of rows a step carries — the dense
products through ``qmatmul``, RMSNorm's mean of squares through
``row_mean_sq`` and a prefill chunk's attention through the decode kernels,
each query row a lane (``models.layers``). A token row then gets the same
bits in a chunk step as in a single-token step (ROADMAP C10). PyTorch runs
eagerly, so the flag is read at every call (the reference reads it once,
at trace time). Training never opens it: ``qmatmul`` has no backward.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

__all__ = ["fused_decode", "fused_decode_enabled"]

_local = threading.local()


@contextmanager
def fused_decode(enabled: bool = True):
    """Route the serve step's attention (and on CUDA its products and
    norms) through the hand-written kernels for every call made inside
    this block."""
    prev = getattr(_local, "fused_decode", False)
    _local.fused_decode = bool(enabled)
    try:
        yield
    finally:
        _local.fused_decode = prev


def fused_decode_enabled() -> bool:
    return getattr(_local, "fused_decode", False)
