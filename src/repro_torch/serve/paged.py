"""Paged KV-cache pool: token-granular memory for the serve engine
(port of ``repro.serve.paged``).

The contiguous :class:`repro_torch.serve.cache.CachePool` reserves a full
``max_len`` KV stripe per slot — memory scales with *reserved* tokens.
This pool allocates one shared array of fixed-size **pages** per
full-context attention layer and maps each lane's logical token blocks
to physical page rows through a host-side **block table**:

* device side — ``k_pages``/``v_pages`` ``(R, P, H_kv, hd)`` in the
  policy's value dtype plus ``pos_pages`` ``(R, P)`` i32 (−1 ⇒ empty
  cell), built by ``make_cache(page_size=…, n_rows=…)``. Row ``R−1`` is
  the **null page**: block-table entries of unmapped blocks point there;
  it is never allocated, and the model layer routes every dropped write
  there with position −1, so its positions stay −1 forever and gathered
  null blocks mask to exact zeros. Ring-window attention layers and recurrent state keep the
  per-slot layout (they are already token-tight);
* host side — a free list of page ids, a per-page **refcount**, and a
  per-lane ``(N, n_blocks)`` block table (``n_blocks =
  ceil(max_len / P)``). :meth:`prepare_write` maps the blocks a lane
  needs to cover its scheduled positions and copy-on-write-remaps any
  *shared* block the lane is about to write; :meth:`release` drops one
  reference per page, returning pages to the free list only when the
  count hits zero. Freshly allocated pages are recycled by the serve
  step's ``page_reset`` mask; CoW copies by its ``copy_dst``/``copy_src``
  rows (:func:`repro_torch.serve.cache.copy_pages`).

**Prefix cache** — because full-context attention KV at position ``p``
is a pure function of the token prefix ``tokens[:p+1]`` (and the
deterministic decode arithmetic), a *full* page of prompt KV can be
shared by every request whose prompt starts with the same tokens. Pages
are keyed by a token-block **hash chain**: ``key_b =
H(key_{b-1} ‖ tokens[bP:(b+1)P])``, so a key commits to the entire
prefix up to the end of block ``b``, not just the block's own tokens.
:meth:`publish_prefix` registers a lane's full prompt blocks in the
index (one extra reference each, so they survive the lane); admission
calls :meth:`match_prefix` + :meth:`adopt_prefix` to map the longest
cached prefix into a new lane's table and skip its prefill. Index-only
pages (refcount 1) are reclaimed LRU-first when the free list runs dry
— cached prefixes never cause preemption.

Token at logical position ``p`` always lands at gathered-view index
``(p // P) * P + p % P = p``, so a paged lane's attention sees exactly
the contiguous cache it would have had — the engine's token-for-token
parity contract vs :func:`repro_torch.serve.decode.generate` survives paging
*and* sharing by construction (asserted in tests/test_torch_paged_engine.py).
"""
from __future__ import annotations

import hashlib
import math
from collections import Counter, deque
from typing import Optional

import numpy as np

from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import pages as PG
from repro_torch.dist import partition as PT
from repro_torch.models import registry as R
from repro_torch.serve import cache as SC

__all__ = ["PagedCachePool"]


def _chain_key(prev: bytes, block_tokens: np.ndarray) -> bytes:
    """One link of the token-block hash chain: commits to the whole
    prefix through ``prev`` plus this block's tokens."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.ascontiguousarray(block_tokens, np.int32).tobytes())
    return h.digest()


class PagedCachePool:
    """Slot + page bookkeeping over one paged cache allocation.

    Slot API matches :class:`repro_torch.serve.cache.CachePool` (``acquire`` /
    ``release`` / ``n_free`` / ``n_active`` / ``cache`` / ``nbytes``), so
    the engine treats both pools uniformly; pages add a second, finer
    allocation axis underneath, and the prefix index a sharing layer on
    top of that: a page may be referenced by several lanes' block tables
    plus the index at once (``_ref`` counts every holder).

    ``n_pages`` defaults to ``n_slots × ceil(max_len / page_size)`` —
    byte-equivalent to the contiguous pool. The serving win comes from
    *undersubscribing*: with mixed-length traffic most sequences never
    come close to ``max_len``, so a pool with far fewer pages (or far
    more slots per page budget) sustains the same traffic; prefix sharing
    stretches the same bytes further again on common-prefix traffic.

    On a ``mesh`` whose data axes exceed 1 (ROADMAP A12 item 3) the device
    side holds this rank's page rows of every paged leaf (``rows``,
    :func:`repro_torch.dist.partition.page_rows`) and its lanes' slots of
    the slot-indexed leaves (``slots``, as :class:`CachePool`'s), and
    ``exchange`` (:class:`repro_torch.dist.pages.PageExchange`) moves the
    rows a step's lanes read across the data ranks. The host side stays
    global and the same on every rank: page ids, free list, refcounts,
    block tables and the prefix index, so every rank makes the same
    admission, preemption and prefix decisions.
    """

    def __init__(self, params, cfg, policy: PrecisionPolicy, *,
                 n_slots: int, max_len: int, page_size: int = 16,
                 n_pages: Optional[int] = None, mesh=None):
        if cfg.encdec:
            raise ValueError("PagedCachePool is decoder-only")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.max_blocks = math.ceil(self.max_len / self.page_size)
        if n_pages is None:
            n_pages = self.n_slots * self.max_blocks
        if n_pages < self.max_blocks:
            raise ValueError(
                f"n_pages ({n_pages}) < blocks per max_len sequence "
                f"({self.max_blocks}): one lane could never finish")
        self.n_pages = int(n_pages)
        # + the null row; on a mesh the row count is padded to a multiple of
        # the data-parallel size, as the reference's (pad rows are never
        # handed out)
        n_rows = self.n_pages + 1
        if mesh is not None:
            n_rows = -(-n_rows // PT.dp_size(mesh)) * PT.dp_size(mesh)
        self.n_rows = n_rows
        self.null_page = self.n_rows - 1   # by convention: the last row
        self.dtype = SC.cache_dtype(policy)
        # this rank's lanes and page rows (all of them in one process); the
        # rows its lanes read from other data ranks move through the exchange
        self.slots = SC.local_slots(self.n_slots, mesh)
        self.rows = PT.page_rows(self.n_rows, mesh)
        dp = 1 if mesh is None else PT.dp_size(mesh)
        self.exchange = (PG.PageExchange(mesh, self.n_rows, self.page_size,
                                         [SC.local_slots(self.n_slots, mesh, index=d)
                                          for d in range(dp)])
                         if dp > 1 else None)
        self.cache = R.make_cache(params, cfg, batch_size=self.slots[1] - self.slots[0],
                                  max_len=self.max_len, dtype=self.dtype,
                                  page_size=self.page_size, n_rows=self.n_rows, mesh=mesh)
        self._free_slots: deque[int] = deque(range(self.n_slots))
        # allocatable pages are [0, n_pages); the null row is never handed out
        self._free_pages: deque[int] = deque(range(self.n_pages))
        # holders per page: one per lane whose table maps it + one when
        # the prefix index holds it. 0 ⟺ on the free list.
        self._ref = np.zeros((self.n_pages,), np.int32)
        self._lane_pages: list[list[int]] = [[] for _ in range(self.n_slots)]
        self.block_table = np.full((self.n_slots, self.max_blocks),
                                   self.null_page, np.int32)
        # prefix index: hash-chain key -> page id. Insertion order is the
        # LRU order (hits re-insert at the end), so reclaim pops from the
        # front.
        self._prefix: dict[bytes, int] = {}

    # -- slot bookkeeping (CachePool-compatible) ----------------------------
    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free_slots)

    def acquire(self) -> Optional[int]:
        """Pop a free slot id (FIFO), or ``None`` when all lanes are busy."""
        return self._free_slots.popleft() if self._free_slots else None

    def release(self, slot: int) -> None:
        """Return a lane: its slot id, and one reference per mapped page
        (pages the prefix index or another lane still holds survive)."""
        if slot in self._free_slots:
            raise ValueError(f"slot {slot} released twice")
        self._free_slots.append(slot)
        self.free_pages(slot)

    # -- page bookkeeping ---------------------------------------------------
    @property
    def n_free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def n_live_pages(self) -> int:
        """Allocated pages (lane-mapped and/or prefix-cached)."""
        return self.n_pages - len(self._free_pages)

    @property
    def n_cached_pages(self) -> int:
        """Pages held by the prefix index (shared or index-only)."""
        return len(self._prefix)

    @property
    def capacity_tokens(self) -> int:
        return self.n_pages * self.page_size

    def blocks_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.page_size)

    def n_reclaimable(self, exclude=()) -> int:
        """Index-only pages (refcount 1) that reclaim could free,
        ``exclude`` aside (admission excludes the pages it just matched,
        which must not be evicted out from under the request)."""
        ex = set(exclude)
        return sum(1 for p in self._prefix.values()
                   if self._ref[p] == 1 and p not in ex)

    def _reclaim(self, k: int, exclude=()) -> int:
        """Evict up to ``k`` index-only pages, LRU first; returns count."""
        ex = set(exclude)
        evicted = 0
        for key, p in list(self._prefix.items()):
            if evicted >= k:
                break
            if self._ref[p] == 1 and p not in ex:
                del self._prefix[key]
                self._ref[p] = 0
                self._free_pages.append(p)
                evicted += 1
        return evicted

    def _alloc(self, need: int, exclude=()) -> bool:
        """Ensure ``need`` free pages, reclaiming cached prefixes LRU-first
        if necessary. False (taking nothing) when impossible."""
        short = need - len(self._free_pages)
        if short > 0:
            self._reclaim(short, exclude)
        return need <= len(self._free_pages)

    def ensure_blocks(self, slot: int, upto_pos: int) -> Optional[list[int]]:
        """Map every block needed for positions ``[0, upto_pos]`` of ``slot``.

        Returns the page ids *newly* pulled from the free list (possibly
        empty), or ``None`` — with no pages taken — when the free list
        (plus reclaimable cached prefixes) cannot cover the need (the
        engine then parks or preempts).
        """
        need = self.blocks_for(upto_pos + 1)
        if need > self.max_blocks:
            raise ValueError(f"position {upto_pos} exceeds max_len "
                             f"{self.max_len}")
        row = self.block_table[slot]
        missing = [b for b in range(need) if row[b] == self.null_page]
        if not self._alloc(len(missing), exclude=row):
            return None
        fresh = [self._free_pages.popleft() for _ in missing]
        for b, p in zip(missing, fresh):
            row[b] = p
            self._ref[p] = 1
        self._lane_pages[slot].extend(fresh)
        return fresh

    def prepare_write(self, slot: int, start: int,
                      n_tokens: int) -> Optional[tuple[list[int],
                                                       list[tuple[int, int]]]]:
        """Ready ``slot`` to write positions ``[start, start + n_tokens)``.

        Two jobs, all-or-nothing: map any block still missing up to the
        last written position (fresh pages, like :meth:`ensure_blocks`),
        and **copy-on-write** any already-mapped block inside the write
        range that the lane *shares* (refcount > 1: the prefix index or
        another lane also holds it) — the shared page stays with its
        other holders, the lane gets a private page and the serve step
        copies the row. Returns ``(fresh_pages, copies)`` with
        ``copies`` as (dst, src) pairs, or ``None`` with nothing taken.
        """
        upto = start + n_tokens - 1
        need = self.blocks_for(upto + 1)
        if need > self.max_blocks:
            raise ValueError(f"position {upto} exceeds max_len "
                             f"{self.max_len}")
        row = self.block_table[slot]
        missing = [b for b in range(need) if row[b] == self.null_page]
        cow = [b for b in range(start // self.page_size,
                                upto // self.page_size + 1)
               if row[b] != self.null_page and self._ref[row[b]] > 1]
        if not self._alloc(len(missing) + len(cow), exclude=row):
            return None
        fresh = [self._free_pages.popleft() for _ in missing]
        for b, p in zip(missing, fresh):
            row[b] = p
            self._ref[p] = 1
        self._lane_pages[slot].extend(fresh)
        copies = []
        for b in cow:
            src = int(row[b])
            dst = self._free_pages.popleft()
            self._ref[src] -= 1                    # lane drops its share
            self._lane_pages[slot].remove(src)
            row[b] = dst
            self._ref[dst] = 1
            self._lane_pages[slot].append(dst)
            copies.append((dst, src))
        return fresh, copies

    def free_pages(self, slot: int) -> list[int]:
        """Drop one reference per page of ``slot``; pages nobody else
        holds return to the free list. Clears the lane's table row."""
        pages = self._lane_pages[slot]
        self._lane_pages[slot] = []
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free_pages.append(p)
        self.block_table[slot] = self.null_page
        return pages

    # -- prefix cache -------------------------------------------------------
    def match_prefix(self, prompt: np.ndarray) -> list[int]:
        """Longest cached prefix of ``prompt``: page ids of the leading
        full blocks found in the index (possibly empty). Hits refresh
        the pages' LRU position. Pages are *not* referenced yet — call
        :meth:`adopt_prefix` to map them into a lane."""
        P = self.page_size
        pages: list[int] = []
        key = b""
        for b in range(prompt.size // P):
            key = _chain_key(key, prompt[b * P:(b + 1) * P])
            page = self._prefix.get(key)
            if page is None:
                break
            del self._prefix[key]          # re-insert at MRU position
            self._prefix[key] = page
            pages.append(page)
        return pages

    def adopt_prefix(self, slot: int, pages: list[int]) -> None:
        """Map matched prefix pages into ``slot``'s leading blocks,
        taking one reference each (the sharing edge of the cache)."""
        row = self.block_table[slot]
        for b, p in enumerate(pages):
            assert row[b] == self.null_page, "adopt into a mapped block"
            row[b] = p
            self._ref[p] += 1
            self._lane_pages[slot].append(p)

    def publish_prefix(self, slot: int, prompt: np.ndarray) -> int:
        """Register ``slot``'s full prompt blocks in the prefix index.

        Called by the engine the moment a lane's prefill completes (the
        pages then hold exactly the prompt-prefix KV). Each newly
        indexed page gains one reference, so it outlives the lane;
        blocks whose chain key is already indexed (the lane adopted
        them, or an identical prompt won the race) are skipped. Returns
        the number of pages published.
        """
        P = self.page_size
        row = self.block_table[slot]
        key = b""
        published = 0
        for b in range(prompt.size // P):
            key = _chain_key(key, prompt[b * P:(b + 1) * P])
            if key in self._prefix:
                continue
            page = int(row[b])
            assert page != self.null_page, "publishing an unmapped block"
            self._prefix[key] = page
            self._ref[page] += 1
            published += 1
        return published

    def clear_prefix(self) -> int:
        """Evict every index entry (frees index-only pages); returns the
        number of pages that went back to the free list."""
        freed = 0
        for p in self._prefix.values():
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free_pages.append(p)
                freed += 1
        self._prefix.clear()
        return freed

    def check_invariants(self) -> None:
        """Alloc/free/refcount invariants (test hook): every page's
        refcount equals its holder count (lanes mapping it + the prefix
        index), pages are free exactly when nobody holds them, and each
        lane's table row maps exactly the pages it owns references to."""
        free = list(self._free_pages)
        assert len(set(free)) == len(free), "duplicate free page"
        lane_refs = Counter(p for pages in self._lane_pages for p in pages)
        index_refs = Counter(self._prefix.values())
        assert all(c == 1 for c in index_refs.values()), \
            "page indexed under two keys"
        for p in range(self.n_pages):
            want = lane_refs[p] + index_refs[p]
            assert self._ref[p] == want, \
                f"page {p}: refcount {self._ref[p]} != holders {want}"
            assert (p in set(free)) == (want == 0), \
                f"page {p}: free-list / holder mismatch"
        for slot, pages in enumerate(self._lane_pages):
            assert len(set(pages)) == len(pages), \
                f"slot {slot} references a page twice"
            mapped = [int(p) for p in self.block_table[slot]
                      if p != self.null_page]
            assert sorted(mapped) == sorted(pages), \
                f"slot {slot}: table/ownership mismatch"
        assert (self.block_table <= self.null_page).all() and \
               (self.block_table >= 0).all()

    def nbytes(self) -> int:
        """This rank's pool bytes: its page rows of every paged leaf, its
        slots of the slot-indexed leaves (the whole pool in one process)."""
        return SC.nbytes(self.cache)

    def page_nbytes(self) -> int:
        """This rank's bytes of the paged leaves (``k_pages``, ``v_pages``,
        ``pos_pages``): its ``rows`` of every layer's."""
        return sum(t.numel() * t.element_size() for _, _, leaf, _ in PG.paged_leaves(self.cache)
                   for t in leaf.values())

    def global_page_nbytes(self) -> int:
        """The paged leaves' bytes of the whole pool, every data rank's rows
        (pad rows included): ``page_nbytes`` scaled to ``n_rows``."""
        return self.page_nbytes() * self.n_rows // (self.rows[1] - self.rows[0])
