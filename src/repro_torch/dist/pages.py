"""The page exchange of a paged KV pool under a data axis above 1
(ROADMAP A12 item 3; in the reference GSPMD moves the rows).

The reference shards a paged pool's rows over the data axes
(``partition.cache_specs``: ``P(data)`` on the row dim) and co-shards its
lanes by slot; GSPMD then moves whatever rows a lane's block table names.
Here data rank ``d`` holds rows :func:`repro_torch.dist.partition.page_rows`
of every paged leaf and computes its own lanes. The host scheduler runs on
every rank with the same decisions (free list, refcounts, block tables,
prefix index), so every rank knows every lane's table, the step's recycled
pages, its copy-on-write pairs and each lane's write positions. From them
:meth:`PageExchange.plan` works out, without a message, what each rank
sends each other rank in a step:

* **pull**, before the model runs: the rows a rank's lanes name that
  another rank owns (a copy-on-write destination reads its source row; a
  page recycled this step is sent by nobody, since its positions are all
  −1 and the reader starts it empty), each row once, and the source row of
  every copy-on-write pair whose destination another rank owns (a pair
  whose rows are both the rank's own is the serve step's
  :func:`repro_torch.serve.cache.copy_pages` on its local rows). The rank
  builds, for every paged leaf, a working buffer of the rows its lanes
  name plus a null row, and its lanes' block tables are remapped onto it.
  The layers run on it unchanged: the paged decode kernel on a
  single-token step, the gathered view of a chunk step on the CPU;
* **push**, after the model: the K/V and position cells its lanes wrote
  into rows another rank owns and computes no lane of. A page written in a
  step is private to its lane (copy-on-write), so no other rank reads it
  in the same step, and the owner's rows end the step as one process's
  pool would.

Rows and cells travel as raw bytes, never indices: sender and receiver
derive the same order. Each direction is one all-to-all of uneven parts
(:func:`repro_torch.optim.grad_compress.exchange_bytes`) over the group of
data ranks that share this rank's model index, skipped on every rank when
the plan moves nothing there, so a step makes at most two collectives,
whatever its layer count. :class:`PageStats` counts them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.dist import partition as PT
from repro_torch.dist.axes import AxisStats
from repro_torch.optim.grad_compress import exchange_bytes

__all__ = ["PAGED_NAMES", "PageStats", "StepPlan", "PageExchange", "paged_leaves"]

PyTree = Any

# the leaves of one paged block, in the order they travel
PAGED_NAMES = ("k_pages", "v_pages", "pos_pages")


def paged_leaves(cache: PyTree) -> list[tuple[str, str, dict, int]]:
    """(root, block, paged dict, page-row dim) of every paged block of a
    decode cache: dim 1 under the stacked ``layers`` root, 0 under
    ``rem``."""
    out = []
    for root, blocks in cache.items():
        for name, leaf in blocks.items():
            if isinstance(leaf, dict) and set(leaf) == set(PAGED_NAMES):
                out.append((root, name, leaf, 1 if root == "layers" else 0))
    return out


def _cells(t: torch.Tensor, pdim: int, rows: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Cells ``(rows[j], offs[j])`` of a page leaf: (…, n, rest) with the
    page dims replaced by the cell index."""
    return t[rows, offs] if pdim == 0 else t[:, rows, offs]


def _set_cells(t: torch.Tensor, pdim: int, rows, offs, value: torch.Tensor) -> None:
    if pdim == 0:
        t[rows, offs] = value
    else:
        t[:, rows, offs] = value


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


@dataclasses.dataclass
class PageStats(AxisStats):
    """What the exchange cost this rank: ``calls``, ``seconds``, ``wire``
    (bytes it handed the collectives, host-copy seconds) as
    :class:`~repro_torch.dist.axes.AxisStats`; the steps it planned, the
    collectives and bytes its plans predicted, the rows and write cells it
    sent, and the largest working buffer it built (bytes, every paged leaf)."""
    steps: int = 0
    planned_calls: int = 0
    planned_bytes: int = 0
    rows_sent: int = 0
    cells_sent: int = 0
    work_peak_bytes: int = 0


@dataclasses.dataclass
class StepPlan:
    """One step's exchange on this rank (host index arrays; global rows are
    the pool's page ids, local rows ``row − lo``).

    ``table`` is this rank's lanes' block tables on the working buffer,
    whose rows are ``work`` (global ids) and then the null row. Pull: the
    working rows copied from the local pool (``local_at`` ← ``local_from``)
    or received (``recv_at[a]`` ← position ``recv_pos[a]`` of what rank
    ``a`` sent: its rows ``recv_rows[a]``), the others (pages recycled this
    step, the null row) starting empty; the
    local rows this rank sends rank ``r`` (``send_rows[r]``); copy-on-write
    pairs of its own rows (``copy_dst`` ← ``copy_src``, local rows at the
    step's static width, for :func:`repro_torch.serve.cache.copy_pages`)
    and of a source another rank owns (``copy_in[a]``: local destination,
    position in rank ``a``'s rows). Push: written cells of its own rows
    (``cell_at``, ``cell_off`` → local ``cell_row``), cells for rank ``o``
    (``out_at[o]``, ``out_off[o]``) and cells from rank ``r`` into its rows
    (``in_row[r]``, ``in_off[r]``). ``pull``/``push`` say whether the
    group makes each collective; ``sent_rows``/``sent_cells`` count what
    this rank hands them."""
    table: np.ndarray
    work: np.ndarray
    local_at: np.ndarray
    local_from: np.ndarray
    recv_at: list
    recv_pos: list
    recv_rows: list
    send_rows: list
    copy_dst: np.ndarray
    copy_src: np.ndarray
    copy_in: list
    cell_at: np.ndarray
    cell_off: np.ndarray
    cell_row: np.ndarray
    out_at: list
    out_off: list
    in_row: list
    in_off: list
    pull: bool
    push: bool
    sent_rows: int
    sent_cells: int


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


class PageExchange:
    """The exchange of one paged pool of ``n_rows`` page rows (padded to a
    multiple of the data size) with ``page_size`` cells per row, whose
    lanes data index ``d`` computes are ``lanes[d]`` (``[lo, hi)``; every
    lane on every index when the slots do not split). ``index`` is this
    rank's data index (default: :func:`~repro_torch.dist.partition.rank_index`).
    The group is the data ranks of this rank's model index, looked up at the
    first collective."""

    def __init__(self, mesh, n_rows: int, page_size: int, lanes: list[tuple[int, int]],
                 index: Optional[int] = None):
        self.mesh = mesh
        self.n = PT.dp_size(mesh)
        if len(lanes) != self.n:
            raise ValueError(f"{len(lanes)} lane ranges for {self.n} data ranks")
        self.index = PT.rank_index(mesh) if index is None else int(index)
        self.n_rows = int(n_rows)
        self.per = self.n_rows // self.n
        self.rows = PT.page_rows(self.n_rows, mesh, self.index)
        self.page_size = int(page_size)
        self.lanes = [tuple(x) for x in lanes]
        self.stats = PageStats()
        self._group = None
        self._sizes: Optional[tuple[int, int]] = None

    @property
    def group(self):
        if self._group is None:
            self._group = self.mesh.dp_group()
        return self._group

    def owner(self, row: int) -> int:
        return int(row) // self.per

    def row_bytes(self, cache: PyTree) -> tuple[int, int]:
        """(bytes of one page row, of one cell) over every paged leaf of
        the pool ``cache``: K, V and positions of every layer. Worked out
        at the first call; they are fixed for the pool's life."""
        if self._sizes is None:
            row = cell = 0
            for _, _, leaf, pdim in paged_leaves(cache):
                for name in PAGED_NAMES:
                    t = leaf[name]
                    per_row = t.numel() // t.shape[pdim] * t.element_size()
                    row += per_row
                    cell += per_row // self.page_size
            self._sizes = (row, cell)
        return self._sizes

    # -- the plan (host) ----------------------------------------------------
    def plan(self, table: np.ndarray, page_reset: np.ndarray, copies: list,
             positions: np.ndarray, copy_width: Optional[int] = None) -> StepPlan:
        """This rank's :class:`StepPlan` for a step: ``table`` (N, n_blocks)
        the pool's block tables after planning, ``page_reset`` (R,) the pages
        recycled this step, ``copies`` its (dst, src) copy-on-write pairs and
        ``positions`` (N, C) each lane's token positions (−1: no write).
        ``copy_width`` is the static width of the step's local copy lists
        (default: the count of this rank's own pairs). They are padded with
        their last pair, which writes the same row again with the same
        bits, or, with none, with the local row count, which copies
        nothing: the local null-row self-copy of
        :func:`repro_torch.models.layers.copy_page_rows` would race a real
        copy into this rank's last row."""
        n, me, P = self.n, self.index, self.page_size
        null = self.n_rows - 1
        lo = self.rows[0]
        src_of = {int(d): int(s) for d, s in copies}
        named = []
        for a, b in self.lanes:
            rows = np.unique(table[a:b])
            named.append(rows[rows != null])
        # need[a][r]: the rows rank a sends rank r
        need = [[set() for _ in range(n)] for _ in range(n)]
        for r in range(n):
            for g in named[r]:
                if page_reset[g]:
                    continue
                s = src_of.get(int(g), int(g))
                if self.owner(s) != r:
                    need[self.owner(s)][r].add(s)
        for d, s in src_of.items():
            if self.owner(s) != self.owner(d):
                need[self.owner(s)][self.owner(d)].add(s)
        sends = [[sorted(need[a][r]) for r in range(n)] for a in range(n)]
        pull = any(sends[a][r] for a in range(n) for r in range(n))
        # the working buffer: this rank's named rows, then the null row
        work = named[me]
        at = {int(g): i for i, g in enumerate(work)}
        remap = np.full((self.n_rows,), len(work), np.int32)
        remap[work] = np.arange(len(work), dtype=np.int32)
        a_lo, a_hi = self.lanes[me]
        local_at, local_from = [], []
        recv_at, recv_pos = [[] for _ in range(n)], [[] for _ in range(n)]
        for i, g in enumerate(work):
            if page_reset[g]:
                continue
            s = src_of.get(int(g), int(g))
            a = self.owner(s)
            if a == me:
                local_at.append(i)
                local_from.append(s - lo)
            else:
                recv_at[a].append(i)
                recv_pos[a].append(sends[a][me].index(s))
        copy_dst, copy_src, copy_in = [], [], [([], []) for _ in range(n)]
        for d, s in src_of.items():
            if self.owner(d) != me:
                continue
            a = self.owner(s)
            if a == me:
                copy_dst.append(d - lo)
                copy_src.append(s - lo)
            else:
                copy_in[a][0].append(d - lo)
                copy_in[a][1].append(sends[a][me].index(s))
        # the cells each lane writes: rank r's lanes in order, tokens in order
        cell_at, cell_off, cell_row = [], [], []
        out_at, out_off = [[] for _ in range(n)], [[] for _ in range(n)]
        in_row, in_off = [[] for _ in range(n)], [[] for _ in range(n)]
        computes = lambda r, i: self.lanes[r][0] <= i < self.lanes[r][1]   # noqa: E731
        push = False
        for r, (l0, l1) in enumerate(self.lanes):
            for i in range(l0, l1):
                for p in positions[i]:
                    if p < 0:
                        continue
                    g = int(table[i, p // P])
                    if g == null:
                        continue
                    o = self.owner(g)
                    if o == r or computes(o, i):
                        if r == me and o == me:
                            cell_at.append(at[g])
                            cell_off.append(p % P)
                            cell_row.append(g - lo)
                        continue
                    push = True
                    if r == me:
                        out_at[o].append(at[g])
                        out_off[o].append(p % P)
                    elif o == me:
                        in_row[r].append(g - lo)
                        in_off[r].append(p % P)
        local_table = remap[table[a_lo:a_hi]]
        width = len(copy_dst) if copy_width is None else int(copy_width)
        pad = (copy_dst[-1], copy_src[-1]) if copy_dst else (self.per, 0)
        copy_dst += [pad[0]] * (width - len(copy_dst))
        copy_src += [pad[1]] * (width - len(copy_src))
        return StepPlan(
            table=local_table, work=work,
            local_at=np.asarray(local_at, np.int64), local_from=np.asarray(local_from, np.int64),
            recv_at=recv_at, recv_pos=recv_pos,
            recv_rows=[len(sends[a][me]) for a in range(n)],
            send_rows=[[s - lo for s in sends[me][r]] for r in range(n)],
            copy_dst=np.asarray(copy_dst, np.int32), copy_src=np.asarray(copy_src, np.int32),
            copy_in=copy_in, cell_at=np.asarray(cell_at, np.int64),
            cell_off=np.asarray(cell_off, np.int64), cell_row=np.asarray(cell_row, np.int64),
            out_at=out_at, out_off=out_off, in_row=in_row, in_off=in_off, pull=pull, push=push,
            sent_rows=sum(len(sends[me][r]) for r in range(n)),
            sent_cells=sum(len(x) for x in out_at))

    def count(self, plan: StepPlan, cache: PyTree) -> None:
        """Add ``plan``'s predicted collectives and bytes to the stats."""
        row, cell = self.row_bytes(cache)
        st = self.stats
        st.steps += 1
        st.planned_calls += int(plan.pull) + int(plan.push)
        st.planned_bytes += plan.sent_rows * row + plan.sent_cells * cell
        st.rows_sent += plan.sent_rows
        st.cells_sent += plan.sent_cells

    # -- the step (device) --------------------------------------------------
    def _exchange(self, parts: list[torch.Tensor], recv_sizes: list[int]) -> list[torch.Tensor]:
        t0 = time.perf_counter()
        got = exchange_bytes(parts, recv_sizes, self.group, self.stats.wire, kind="pages")
        self.stats.calls += 1
        self.stats.seconds += time.perf_counter() - t0
        return got

    def pull(self, cache: PyTree, plan: StepPlan) -> PyTree:
        """Move the rows of the plan, apply the copy-on-write pairs whose
        source another rank sent, and return ``cache`` with every paged leaf
        replaced by its working buffer (the other leaves are the cache's
        own). The step has applied this rank's own pairs."""
        self.count(plan, cache)
        blocks = paged_leaves(cache)
        dev = blocks[0][2]["pos_pages"].device
        # what every peer sent this rank, per block and leaf
        recv = [None] * self.n
        if plan.pull:
            parts = []
            for r in range(self.n):
                idx = _idx(plan.send_rows[r], dev)
                parts.append(torch.cat([_as_bytes(leaf[name].index_select(pdim, idx))
                                        for _, _, leaf, pdim in blocks for name in PAGED_NAMES])
                             if len(plan.send_rows[r]) else torch.empty(0, dtype=torch.uint8,
                                                                        device=dev))
            row, _ = self.row_bytes(cache)
            got = self._exchange(parts, [k * row for k in plan.recv_rows])
            for a in range(self.n):
                recv[a] = self._unpack_rows(got[a], blocks, plan.recv_rows[a])
        for a in range(self.n):
            dst, pos = plan.copy_in[a]
            if dst:
                dst_t, pos_t = _idx(dst, dev), _idx(pos, dev)
                for (_, _, leaf, pdim), rows in zip(blocks, recv[a]):
                    for name in PAGED_NAMES:
                        leaf[name].index_copy_(pdim, dst_t, rows[name].index_select(pdim, pos_t))
        # the working buffers
        n_work = len(plan.work) + 1
        local_at, local_from = _idx(plan.local_at, dev), _idx(plan.local_from, dev)
        work_cache = {root: dict(blocks_) for root, blocks_ in cache.items()}
        nbytes = 0
        for bi, (root, bname, leaf, pdim) in enumerate(blocks):
            wleaf = {}
            for name in PAGED_NAMES:
                t = leaf[name]
                shape = list(t.shape)
                shape[pdim] = n_work
                w = (torch.full(shape, -1, dtype=t.dtype, device=dev) if name == "pos_pages"
                     else torch.zeros(shape, dtype=t.dtype, device=dev))
                w.index_copy_(pdim, local_at, t.index_select(pdim, local_from))
                for a in range(self.n):
                    if plan.recv_at[a]:
                        w.index_copy_(pdim, _idx(plan.recv_at[a], dev),
                                      recv[a][bi][name].index_select(pdim,
                                                                     _idx(plan.recv_pos[a], dev)))
                wleaf[name] = w
                nbytes += w.numel() * w.element_size()
            work_cache[root][bname] = wleaf
        self.stats.work_peak_bytes = max(self.stats.work_peak_bytes, nbytes)
        return work_cache

    def _unpack_rows(self, buf: torch.Tensor, blocks, k: int) -> list[dict]:
        """A peer's ``k`` rows of every block's leaves out of its bytes."""
        out, at = [], 0
        for _, _, leaf, pdim in blocks:
            rows = {}
            for name in PAGED_NAMES:
                t = leaf[name]
                shape = list(t.shape)
                shape[pdim] = k
                size = int(np.prod(shape)) * t.element_size()
                rows[name] = buf[at:at + size].view(t.dtype).reshape(shape)
                at += size
            out.append(rows)
        return out

    def push(self, cache: PyTree, work: PyTree, plan: StepPlan) -> None:
        """Write the cells this rank's lanes wrote into the working buffers
        back to their owners' rows: its own rows here, the others' through
        the push collective."""
        blocks = paged_leaves(cache)
        dev = blocks[0][2]["pos_pages"].device
        wblocks = [work[root][bname] for root, bname, _, _ in blocks]
        if plan.cell_at.size:
            at, off, row = (_idx(x, dev) for x in (plan.cell_at, plan.cell_off, plan.cell_row))
            for (_, _, leaf, pdim), wleaf in zip(blocks, wblocks):
                for name in PAGED_NAMES:
                    _set_cells(leaf[name], pdim, row, off, _cells(wleaf[name], pdim, at, off))
        if not plan.push:
            return
        parts = []
        for o in range(self.n):
            if not plan.out_at[o]:
                parts.append(torch.empty(0, dtype=torch.uint8, device=dev))
                continue
            at, off = _idx(plan.out_at[o], dev), _idx(plan.out_off[o], dev)
            parts.append(torch.cat([_as_bytes(_cells(wleaf[name], pdim, at, off))
                                    for (_, _, _, pdim), wleaf in zip(blocks, wblocks)
                                    for name in PAGED_NAMES]))
        _, cell = self.row_bytes(cache)
        got = self._exchange(parts, [len(x) * cell for x in plan.in_row])
        for r in range(self.n):
            if not plan.in_row[r]:
                continue
            k = len(plan.in_row[r])
            row, off = _idx(plan.in_row[r], dev), _idx(plan.in_off[r], dev)
            at = 0
            for _, _, leaf, pdim in blocks:
                for name in PAGED_NAMES:
                    t = leaf[name]
                    shape = list(_cells(t, pdim, row[:0], off[:0]).shape)
                    shape[pdim] = k
                    size = int(np.prod(shape)) * t.element_size()
                    _set_cells(t, pdim, row, off,
                               got[r][at:at + size].view(t.dtype).reshape(shape))
                    at += size
