"""Kernel dispatch context (port of ``repro.kernels.dispatch``).

A thread-local flag that lets an entry point (``make_serve_step``, a
bench, ``generate`` callers) route ``models.layers.decode_attention``
through the hand-written decode kernel without threading a flag through
every layer. PyTorch runs eagerly, so the flag is read at every call
(the reference reads it once, at trace time).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

__all__ = ["fused_decode", "fused_decode_enabled"]

_local = threading.local()


@contextmanager
def fused_decode(enabled: bool = True):
    """Route ``repro_torch.models.layers.decode_attention`` through the
    fused decode kernel for every call made inside this block."""
    prev = getattr(_local, "fused_decode", False)
    _local.fused_decode = bool(enabled)
    try:
        yield
    finally:
        _local.fused_decode = prev


def fused_decode_enabled() -> bool:
    return getattr(_local, "fused_decode", False)
