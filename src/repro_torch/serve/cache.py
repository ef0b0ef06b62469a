"""Slotted KV-cache pool and the per-slot and per-page primitives (port of
``repro.serve.cache``, no mesh).

The decode cache is built **once** for ``n_slots`` lanes and ``max_len``
positions, and requests are mapped onto slots. A contiguous attention
cache is a ``(k, v, k_pos)`` tuple — k/v ``(L, N, S_c, H_kv, hd)`` in the
policy's value dtype and an i32 position map ``(L, N, S_c)`` whose −1
cells are empty — so the slot axis is dim 1 under the stacked ``layers``
root. A paged cache is a dict of :data:`PAGED_KEYS` — pages
``(L, R, P, H_kv, hd)`` and positions ``(L, R, P)`` — whose dim 1 is the
*page* axis; its lifecycle is page-granular (:func:`reset_pages`,
:func:`copy_pages` and the pool's block tables,
:mod:`repro_torch.serve.paged`), so the per-slot helpers skip it.

A slot (or page) is recycled by setting its positions to −1, which makes
every stale KV cell unreachable (attention masks on the positions, never
on the values); the KV values are never rewritten, yet a recycled slot
decodes bitwise like a fresh one.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Optional

import torch

from repro_torch.core.policy import PrecisionPolicy
from repro_torch.models import registry as R
from repro_torch.models.layers import copy_page_rows

__all__ = ["CachePool", "PAGED_KEYS", "cache_dtype", "copy_pages", "keep_active",
           "reset_pages", "reset_slots"]

PyTree = Any

# Leaf names of the paged KV layout (see ``models.transformer.init_cache``).
PAGED_KEYS = frozenset({"k_pages", "v_pages", "pos_pages"})


def cache_dtype(policy: PrecisionPolicy) -> torch.dtype:
    """Value dtype for KV under ``policy``: its compute dtype (bf16 for
    the 16-bit policies; f32 for fp32 and the simulated sub-16-bit grids).
    Position maps are always i32."""
    return policy.compute_dtype


def _attention_leaves(cache: PyTree):
    """(leaf, slot-or-page dim) of every attention cache: ``(k, v, k_pos)``
    tuples and paged dicts; raises on state of families not ported yet."""
    for root, blocks in cache.items():
        for name, leaf in blocks.items():
            paged = isinstance(leaf, dict) and set(leaf) == PAGED_KEYS
            if not (paged or isinstance(leaf, tuple)):
                raise NotImplementedError(
                    f"cache leaf {root}.{name} is recurrent state; only "
                    "attention caches are ported")
            yield leaf, 1 if root == "layers" else 0


def _per(mask: torch.Tensor, leaf: torch.Tensor, dim: int) -> torch.Tensor:
    """Broadcast a (N,) mask against ``leaf`` along ``dim``."""
    shape = [1] * leaf.ndim
    shape[dim] = mask.shape[0]
    return mask.reshape(shape)


def reset_slots(cache: PyTree, reset: torch.Tensor) -> PyTree:
    """Re-initialize the slots selected by ``reset`` ((N,) bool) in place:
    their position maps go to −1. KV values stay (dead behind pos = −1);
    paged leaves are left to :func:`reset_pages`."""
    for leaf, sdim in _attention_leaves(cache):
        if isinstance(leaf, tuple):
            k_pos = leaf[2]
            k_pos.masked_fill_(_per(reset, k_pos, sdim), -1)
    return cache


def reset_pages(cache: PyTree, page_mask: torch.Tensor) -> PyTree:
    """Re-initialize the physical pages selected by ``page_mask`` ((R,)
    bool) in place: only their ``pos_pages`` rows go to −1, which makes
    every KV cell of a recycled page unreachable, so handing a freed page
    to a new sequence never streams ``k_pages``/``v_pages``. Contiguous
    leaves pass through."""
    for leaf, pdim in _attention_leaves(cache):
        if isinstance(leaf, dict):
            pos = leaf["pos_pages"]
            pos.masked_fill_(_per(page_mask, pos, pdim), -1)
    return cache


def copy_pages(cache: PyTree, dst: torch.Tensor, src: torch.Tensor) -> PyTree:
    """Copy-on-write page copies in place: row ``src[j]`` → row ``dst[j]``
    on every paged leaf (``k_pages``/``v_pages``/``pos_pages``).

    The serve step applies this *after* :func:`reset_pages` and *before*
    the model's KV writes, so a lane whose first write lands in a block it
    shares writes into a private copy that already carries the shared
    content, positions included. ``dst``/``src`` are (K,) integer tensors
    of a static width; entries with ``dst`` ≥ the pool's row count are
    padding and copy nothing (:func:`repro_torch.models.layers
    .copy_page_rows`). Contiguous leaves pass through."""
    for leaf, pdim in _attention_leaves(cache):
        if isinstance(leaf, dict):
            for name in sorted(PAGED_KEYS):
                copy_page_rows(leaf[name], dst, src, pdim)
    return cache


def keep_active(active: torch.Tensor, new: PyTree, old: PyTree) -> PyTree:
    """Per-slot select of ``new`` where ``active``, else ``old``.

    The reference selects recurrent state here and passes attention
    caches through: parked lanes never change them (their KV write is a
    no-op, see ``models.layers.attention_apply``). The ported caches hold
    attention caches only (``_attention_leaves`` raises on anything else),
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
        return nbytes(self.cache)


def nbytes(cache: PyTree) -> int:
    """Bytes of every attention leaf of ``cache``, contiguous or paged."""
    total = 0
    for leaf, _ in _attention_leaves(cache):
        for t in (leaf.values() if isinstance(leaf, dict) else leaf):
            total += t.numel() * t.element_size()
    return total
