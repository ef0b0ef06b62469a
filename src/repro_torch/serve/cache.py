"""Slotted decode-cache pool and the per-slot and per-page primitives
(port of ``repro.serve.cache``).

The decode cache is built **once** for ``n_slots`` lanes and ``max_len``
positions, and requests are mapped onto slots. Its tree is what
:func:`repro_torch.models.transformer.init_cache` builds: under the
stacked ``layers`` root every leaf has a leading group dim, so the slot
axis is dim 1; under the unstacked ``rem`` root it is dim 0. Per block:

* a contiguous attention cache ``(k, v, k_pos)`` — k/v ``(…, N, S_c,
  H_kv, hd)`` in the policy's value dtype and an i32 position map whose −1
  cells are empty (``S_c = min(max_len, window)`` for sliding-window and
  local attention: a ring);
* a paged attention cache, a dict of :data:`PAGED_KEYS` whose slot-dim is
  the *page* axis; its lifecycle is page-granular (:func:`reset_pages`,
  :func:`copy_pages` and the pool's block tables,
  :mod:`repro_torch.serve.paged`), so the per-slot helpers skip it;
* recurrent state, a dict of :data:`RECURRENT_KEYS` — Mamba ``conv (…, N,
  W-1, d_inner)`` in the value dtype and ``h (…, N, d_inner, N_ssm)`` f32,
  RG-LRU ``conv (…, N, W-1, W)`` and ``h (…, N, W)`` f32.

A slot is recycled by setting its positions to −1, which makes every
stale KV cell unreachable (attention masks on the positions, never on the
values), and by zeroing its recurrent state; the KV values are never
rewritten, yet a recycled slot decodes bitwise like a fresh one. A decode
step rewrites recurrent state wholesale, garbage in parked lanes included,
so the serve step keeps it per lane with :func:`keep_active`.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Optional

import torch

from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import partition as PT
from repro_torch.models import registry as R
from repro_torch.models.layers import copy_page_rows

__all__ = ["CachePool", "ENCDEC_ROUTE", "PAGED_KEYS", "RECURRENT_KEYS", "cache_dtype", "copy_pages",
           "keep_active", "local_slots", "reset_pages", "reset_slots"]

PyTree = Any

# Leaf names of the paged KV layout and of recurrent state (see
# ``models.transformer.init_cache``).
PAGED_KEYS = frozenset({"k_pages", "v_pages", "pos_pages"})
RECURRENT_KEYS = frozenset({"conv", "h"})

# Where the pools' and the engine's refusals of an encoder-decoder config
# point. The reference's point at ``generate``, which cannot serve one
# (ROADMAP C15).
ENCDEC_ROUTE = ("models decode in lock-step through registry.make_cache(batch=...) "
                "and registry.decode")


def cache_dtype(policy: PrecisionPolicy) -> torch.dtype:
    """Value dtype for KV and conv state under ``policy``: its compute
    dtype (bf16 for the 16-bit policies; f32 for fp32 and the simulated
    sub-16-bit grids). Position maps are always i32, recurrent ``h`` f32."""
    return policy.compute_dtype


def _blocks(cache: PyTree, kind: str):
    """(block cache, slot-or-page dim) of every block of ``kind``:
    ``"kv"`` contiguous attention tuples, ``"paged"`` paged dicts,
    ``"recurrent"`` conv/h dicts. Walks ``layers`` (dim 1) and ``rem``
    (dim 0); raises on a leaf of no known layout."""
    for root, blocks in cache.items():
        for name, leaf in blocks.items():
            if isinstance(leaf, tuple):
                found = "kv"
            elif isinstance(leaf, dict) and set(leaf) == PAGED_KEYS:
                found = "paged"
            elif isinstance(leaf, dict) and set(leaf) == RECURRENT_KEYS:
                found = "recurrent"
            else:
                raise ValueError(f"cache leaf {root}.{name} has no known layout")
            if found == kind:
                yield leaf, 1 if root == "layers" else 0


def _per(mask: torch.Tensor, leaf: torch.Tensor, dim: int) -> torch.Tensor:
    """Broadcast a (N,) mask against ``leaf`` along ``dim``."""
    shape = [1] * leaf.ndim
    shape[dim] = mask.shape[0]
    return mask.reshape(shape)


def reset_slots(cache: PyTree, reset: torch.Tensor) -> PyTree:
    """Re-initialize the slots selected by ``reset`` ((N,) bool) in place:
    their position maps go to −1 and their recurrent state to zero. KV
    values stay (dead behind pos = −1); paged leaves are left to
    :func:`reset_pages`."""
    for leaf, sdim in _blocks(cache, "kv"):
        leaf[2].masked_fill_(_per(reset, leaf[2], sdim), -1)
    for state, sdim in _blocks(cache, "recurrent"):
        for t in state.values():
            t.masked_fill_(_per(reset, t, sdim), 0)
    return cache


def reset_pages(cache: PyTree, page_mask: torch.Tensor) -> PyTree:
    """Re-initialize the physical pages selected by ``page_mask`` ((R,)
    bool) in place: only their ``pos_pages`` rows go to −1, which makes
    every KV cell of a recycled page unreachable, so handing a freed page
    to a new sequence never streams ``k_pages``/``v_pages``. Slot-indexed
    leaves pass through."""
    for leaf, pdim in _blocks(cache, "paged"):
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
    .copy_page_rows`). Slot-indexed leaves pass through."""
    for leaf, pdim in _blocks(cache, "paged"):
        for name in sorted(PAGED_KEYS):
            copy_page_rows(leaf[name], dst, src, pdim)
    return cache


def keep_active(active: Optional[torch.Tensor], new: PyTree, old: PyTree) -> PyTree:
    """Per-slot select of the recurrent state, written into ``old`` in
    place: ``where(active, new, old)`` ((N,) bool; every lane when
    ``active`` is None). Returns ``old``.

    A decode step rewrites recurrent state wholesale, parked lanes' garbage
    included; this keeps their state. Attention caches pass through: the
    step wrote them in place, and parked lanes never change them (their KV
    write is a no-op, see ``models.layers.attention_apply``). Writing into
    ``old`` keeps the state in the buffers a captured serve-step graph
    reads."""
    for root, blocks in old.items():
        if not isinstance(blocks, dict):    # the encoder-decoder's: no recurrent state
            continue
        sdim = 1 if root == "layers" else 0
        for name, state in blocks.items():
            if not (isinstance(state, dict) and set(state) == RECURRENT_KEYS):
                continue
            for k, t in state.items():
                n = new[root][name][k]
                if n is t:
                    continue
                t.copy_(n if active is None else torch.where(_per(active, t, sdim), n, t))
    return old


def local_slots(n_slots: int, mesh, index: Optional[int] = None) -> tuple[int, int]:
    """The slot range ``[lo, hi)`` whose state data index ``index``
    (default: this rank's) holds: on a mesh whose data axes divide the
    slots, its contiguous share (the reference's slot spec,
    ``partition.cache_specs``); otherwise every slot (they replicate, as
    the reference's do)."""
    n = 1 if mesh is None else PT.dp_size(mesh)
    if n == 1 or n_slots % n:
        return 0, n_slots
    per = n_slots // n
    at = PT.rank_index(mesh) if index is None else index
    return at * per, (at + 1) * per


class CachePool:
    """One decode-cache allocation + host-side slot bookkeeping.

    The device side (``self.cache``) is built by ``make_cache`` on the
    parameters' device, for ``n_slots`` lanes — or, on a ``mesh``, for the
    lanes of :func:`local_slots` (``self.slots``), with the kv heads of
    this rank's attention kernels. The host side, the same on every rank,
    is a FIFO free list over all ``n_slots``: :meth:`acquire` hands out
    slot ids, :meth:`release` returns them; the state reset happens in the
    serve step via :func:`reset_slots`.
    """

    def __init__(self, params, cfg, policy: PrecisionPolicy, *,
                 n_slots: int, max_len: int, mesh=None):
        if cfg.encdec:
            raise ValueError(f"CachePool is decoder-only; encoder-decoder {ENCDEC_ROUTE}")
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.dtype = cache_dtype(policy)
        self.slots = local_slots(self.n_slots, mesh)
        self.cache = R.make_cache(params, cfg, batch_size=self.slots[1] - self.slots[0],
                                  max_len=self.max_len, dtype=self.dtype, mesh=mesh)
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
    """Bytes of every leaf of ``cache``: attention, contiguous or paged,
    and recurrent state."""
    total = 0
    for kind in ("kv", "paged", "recurrent"):
        for leaf, _ in _blocks(cache, kind):
            for t in (leaf.values() if isinstance(leaf, dict) else leaf):
                total += t.numel() * t.element_size()
    return total
