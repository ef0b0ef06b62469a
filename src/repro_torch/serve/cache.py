"""Slotted KV-cache pool and per-slot reset (port of ``repro.serve.cache``,
contiguous pool, no mesh).

The decode cache is built **once** for ``n_slots`` lanes and ``max_len``
positions, and requests are mapped onto slots. Attention caches are
``(k, v, k_pos)`` tuples — k/v ``(L, N, S_c, H_kv, hd)`` in the policy's
value dtype and an i32 position map ``(L, N, S_c)`` whose −1 cells are
empty — so the slot axis is dim 1 under the stacked ``layers`` root.

A slot is recycled by setting its position map to −1, which makes every
stale KV cell unreachable (attention masks on the map, never on the
values); the KV values are never rewritten, yet a recycled slot decodes
bitwise like a fresh one.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Optional

import torch

from repro_torch.core.policy import PrecisionPolicy
from repro_torch.models import registry as R

__all__ = ["CachePool", "cache_dtype", "keep_active", "reset_slots"]

PyTree = Any


def cache_dtype(policy: PrecisionPolicy) -> torch.dtype:
    """Value dtype for KV under ``policy``: its compute dtype (bf16 for
    the 16-bit policies; f32 for fp32 and the simulated sub-16-bit grids).
    Position maps are always i32."""
    return policy.compute_dtype


def _attention_leaves(cache: PyTree):
    """(k, v, k_pos, slot_dim) of every attention cache; raises on state
    of families not ported yet."""
    for root, blocks in cache.items():
        for name, leaf in blocks.items():
            if not isinstance(leaf, tuple):
                raise NotImplementedError(
                    f"cache leaf {root}.{name} is recurrent state; only "
                    "attention caches are ported")
            yield (*leaf, 1 if root == "layers" else 0)


def reset_slots(cache: PyTree, reset: torch.Tensor) -> PyTree:
    """Re-initialize the slots selected by ``reset`` ((N,) bool) in place:
    their position maps go to −1. KV values stay (dead behind pos = −1)."""
    for _, _, k_pos, sdim in _attention_leaves(cache):
        shape = [1] * k_pos.ndim
        shape[sdim] = reset.shape[0]
        k_pos.masked_fill_(reset.reshape(shape), -1)
    return cache


def keep_active(active: torch.Tensor, new: PyTree, old: PyTree) -> PyTree:
    """Per-slot select of ``new`` where ``active``, else ``old``.

    The reference selects recurrent state here and passes attention
    tuples through: parked lanes never change them (their KV write is a
    no-op, see ``models.layers.attention_apply``). The ported caches hold
    attention tuples only (``_attention_leaves`` raises on anything else),
    so every leaf passes through."""
    del active, old
    list(_attention_leaves(new))
    return new


class CachePool:
    """One decode-cache allocation + host-side slot bookkeeping.

    The device side (``self.cache``) is built by ``make_cache`` for
    ``n_slots`` lanes on the parameters' device. The host side is a FIFO
    free list: :meth:`acquire` hands out slot ids, :meth:`release` returns
    them; the state reset happens in the serve step via
    :func:`reset_slots`.
    """

    def __init__(self, params, cfg, policy: PrecisionPolicy, *,
                 n_slots: int, max_len: int):
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.dtype = cache_dtype(policy)
        self.cache = R.make_cache(params, cfg, batch_size=self.n_slots,
                                  max_len=self.max_len, dtype=self.dtype)
        self._free: deque[int] = deque(range(self.n_slots))

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free)

    def acquire(self) -> Optional[int]:
        """Pop a free slot id (FIFO), or ``None`` when the pool is full."""
        return self._free.popleft() if self._free else None

    def release(self, slot: int) -> None:
        if slot in self._free:
            raise ValueError(f"slot {slot} released twice")
        self._free.append(slot)

    def nbytes(self) -> int:
        """Total pool bytes."""
        return sum(t.numel() * t.element_size()
                   for k, v, k_pos, _ in _attention_leaves(self.cache)
                   for t in (k, v, k_pos))
