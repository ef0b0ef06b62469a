"""Fused single-token decode attention over the contiguous slotted KV pool
and over the paged KV pool.

Replaces the Pallas kernels ``repro/kernels/decode_attention.py:42``
(``decode_attention_kernel``, wrapper ``:71`` ``fused_decode_attention``)
and ``:102`` (``paged_decode_attention_kernel``, wrapper ``:148``
``fused_paged_decode_attention``) with one CUDA kernel body written for
Hopper, ``csrc/decode_attention.cu``, entered through two C functions
that differ only in how a key index becomes a row of K/V: ``b·Sc + key``
for the contiguous pool, ``table[b, key // P]·P + key % P`` for the
paged pool. The contiguous entry also takes a lane → cache-row map, so
that the query rows of a prefill chunk run as lanes of their own, each
over its lane's cache in place. Per lane, in the reference's op order: f32
scores ``q.k / sqrt(D)``, optional softcap tanh, the mask
``0 <= k_pos <= q_pos`` (plus the window), a full-row softmax, the
probabilities cast to ``p_dtype``, PV accumulated in f32, an unrounded f32
output (the caller rounds once). A parked lane (``q_pos < 0``) gives zeros.

Each (lane, kv head) runs on a thread-block cluster of :data:`CLUSTER`
blocks that meet through distributed shared memory. The cluster finds the
lane's visible key range from the positions (the contiguous pool is a
ring, so view index is not position) and splits it evenly, so keys outside
it cost no loop trips; each thread stages its slice of its keys' K and V
rows through its own ``cp.async`` ring in shared memory, reading each row
once for the G query heads of the group and no bytes of masked rows; the
blocks exchange the row's max and then its sum before any block rounds p.
The probabilities are rounded to ``p_dtype`` only after the global
normalisation, as the reference does: a flash-decoding merge of
unnormalised partial sums would never round the normalised p, and so
computes another function. Every sum runs in a fixed order, so repeated
calls are bitwise equal. A block holds only its share of the score row,
so views of up to :func:`max_keys` keys fit (35072 at G = 8, D = 128). A
block holds at most 8 query rows; a group of up to 16 heads (recurrentgemma's
10 on one kv head) is split evenly over ceil(G / 8) clusters that read the
same K/V rows (:func:`part_rows`), and a head's bits do not depend on G.

By its bytes the kernel would be bound by HBM, far below the tensor cores'
ridge; it does its arithmetic on CUDA cores, and on the card that
arithmetic and the staging around it, not the bytes, set its pace
(PERF.md). See the note at the top of the CUDA source.

:func:`fused_decode_attention` and :func:`fused_paged_decode_attention`
launch the kernel for CUDA tensors and raise if they cannot; only for CPU
tensors do they run the plain PyTorch versions :func:`decode_attention_ref`
and :func:`paged_decode_attention_ref`, which the tests and
``chip_smoke.py`` hold the kernel against. The launch (grid, shared
memory: :func:`smem_bytes`) depends only on the view length, G and D, and
the body only on the key → row map, so
the paged kernel on a pool is bitwise equal to the contiguous kernel on the
gathered view ``pages[block_table]``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "PAGED_LAUNCHES", "decode_attention_ref", "fused_decode_attention",
           "paged_decode_attention_ref", "fused_paged_decode_attention", "smem_bytes",
           "max_keys", "part_rows"]

NEG_INF = -1e30
# mirrors of the constants of csrc/decode_attention.cu
THREADS = 256          # kThreads: threads per block
CLUSTER = 8            # kCluster: blocks per (lane, kv head), one cluster
ROWS = 8               # kRows: query rows of a block, at most; the layouts' rows
MAX_GROUP = 16         # kMaxGroup: query heads per kv head, at most
HEAD_DIMS = (32, 64, 128, 256)   # the D the kernel is built for
STAT_WORDS = 4 + 2 * CLUSTER * ROWS + (THREADS // 32) * ROWS + ROWS   # kStatWords
RING_BYTES = 65536     # kRingBytes: K or V bytes in flight per block
MAX_SMEM = 232448      # kMaxSmem: the 227 KB of shared memory a block may opt into
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# Kernel launches made by fused_decode_attention and by
# fused_paged_decode_attention (each incremented per launch).
LAUNCHES = 0
PAGED_LAUNCHES = 0


def decode_attention_ref(q, k_cache, v_cache, k_pos, q_pos, *, lane_rows=None,
                         window=None, softcap=None, p_dtype=torch.bfloat16):
    """Plain PyTorch version, in ``repro.models.layers.decode_attention``'s
    op order (S=1). q: (B,1,Hq,D); caches: (N,Sc,Hkv,D); k_pos: (N,Sc) i32;
    q_pos: (B,) i32, −1 ⇒ parked lane (zeros). Lane b attends over cache
    row b (N = B), or over row ``lane_rows[b]`` when that (B,) integer map
    is given. Returns f32 (B,1,Hq,D)."""
    if lane_rows is not None:
        rows = lane_rows.long()
        k_cache, v_cache, k_pos = k_cache[rows], v_cache[rows], k_pos[rows]
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).to(torch.float32)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.to(torch.float32)) \
        * (1.0 / math.sqrt(D))
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp = q_pos.reshape(B, 1, 1, 1)
    kp = k_pos[:, None, None, :]
    ok = (kp <= qp) & (kp >= 0)
    if window is not None:
        ok &= qp - kp < window
    s = torch.where(ok, s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(p_dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    out = torch.where(qp >= 0, out, 0.0)
    return out.reshape(B, 1, Hq, D)


def fused_decode_attention(q, k_cache, v_cache, k_pos, q_pos, *, lane_rows=None,
                           window=None, softcap=None, p_dtype=torch.bfloat16):
    """The decode kernel: q (B,1,Hq,D); caches (N,Sc,Hkv,D) bf16 or f32;
    k_pos (N,Sc) i32; q_pos (B,) (−1 ⇒ parked lane). Lane b reads cache
    row b (N = B) or, given ``lane_rows`` ((B,) int32 in [0, N)), row
    ``lane_rows[b]`` in place: the query rows of a prefill chunk then run
    as lanes of their own over their lane's cache. Returns f32
    (B,1,Hq,D), unrounded. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, k_pos, q_pos,
                                    lane_rows=lane_rows, window=window,
                                    softcap=softcap, p_dtype=p_dtype)
    return _launch(q, k_cache, v_cache, k_pos, q_pos, lane_rows, window=window,
                   softcap=softcap, p_dtype=p_dtype)


def _gather_view(pages, block_table):
    """The lanes' views of a paged pool: (R,P,...) rows through a (B,n)
    table → (B, n·P, ...)."""
    B, n = block_table.shape
    view = pages[block_table.long()]
    return view.reshape(B, n * pages.shape[1], *pages.shape[2:])


def paged_decode_attention_ref(q, k_pages, v_pages, pos_pages, block_table, q_pos,
                               *, window=None, softcap=None,
                               p_dtype=torch.bfloat16):
    """Plain PyTorch version of the paged kernel: gather each lane's view
    ``pages[block_table]`` and attend over it with :func:`decode_attention_ref`
    — the reference's generic gathered path (``repro.models.layers
    .attention_apply``'s paged branch). Token at logical position p sits at
    view index p; null blocks carry positions −1 and mask out."""
    return decode_attention_ref(q, _gather_view(k_pages, block_table),
                                _gather_view(v_pages, block_table),
                                _gather_view(pos_pages, block_table), q_pos,
                                window=window, softcap=softcap, p_dtype=p_dtype)


def fused_paged_decode_attention(q, k_pages, v_pages, pos_pages, block_table, q_pos,
                                 *, window=None, softcap=None,
                                 p_dtype=torch.bfloat16):
    """The paged decode kernel: q (B,1,Hq,D); pools (R,P,Hkv,D) bf16 or
    f32 and positions (R,P) i32; block_table (B,n_blocks) i32 of pool rows
    (null blocks point at a row whose positions are −1); q_pos (B,) (−1 ⇒
    parked lane). Returns f32 (B,1,Hq,D), unrounded. CPU tensors take the
    plain version."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, pos_pages, block_table,
                                          q_pos, window=window, softcap=softcap,
                                          p_dtype=p_dtype)
    global PAGED_LAUNCHES
    B, _, Hq, D = q.shape
    R, P, Hkv, _ = k_pages.shape
    n_blocks = block_table.shape[-1]
    if q_pos.dtype != torch.int32:
        q_pos = q_pos.to(torch.int32)
    _check(q, q_pos, p_dtype, Hkv, n_blocks * P,
           {"k_pages": k_pages, "v_pages": v_pages, "pos_pages": pos_pages,
            "block_table": block_table})
    if k_pages.shape != (R, P, Hkv, D) or v_pages.shape != k_pages.shape \
            or pos_pages.shape != (R, P) or block_table.shape != (B, n_blocks):
        raise ValueError(f"shapes q {tuple(q.shape)}, k_pages {tuple(k_pages.shape)}, "
                         f"v_pages {tuple(v_pages.shape)}, pos_pages "
                         f"{tuple(pos_pages.shape)}, block_table "
                         f"{tuple(block_table.shape)} do not form a paged GQA decode")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"q/k_pages/v_pages must share one dtype of {list(_DTYPES)}, "
                         f"got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if pos_pages.dtype != torch.int32 or block_table.dtype != torch.int32:
        raise ValueError(f"pos_pages and block_table must be int32, got "
                         f"{pos_pages.dtype} and {block_table.dtype}")
    out = torch.empty((B, 1, Hq, D), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), pos_pages.data_ptr(),
            block_table.data_ptr(), q_pos.data_ptr(), out.data_ptr(), B, n_blocks, P,
            Hkv, Hq // Hkv, D, *_scalars(D, window, softcap, p_dtype, q.dtype))
    with torch.cuda.device(q.device):
        rc = _kernel("repro_paged_decode_attention", 7, 6)(
            *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged decode_attention kernel launch failed: CUDA error {rc}")
    PAGED_LAUNCHES += 1
    return out


@functools.cache
def _kernel(name: str, n_ptrs: int, n_ints: int):
    """A C entry point of the kernel library, built and loaded at first use."""
    fn = getattr(_build.load("decode_attention"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    return fn


def _scalars(D, window, softcap, p_dtype, dtype):
    """scale, window, softcap, round_p, dtype as the C entry points take them."""
    return (1.0 / math.sqrt(D), -1 if window is None else int(window),
            float(softcap) if softcap else 0.0, int(p_dtype == torch.bfloat16),
            _DTYPES[dtype])


def part_rows(G: int) -> int:
    """Query rows of one block (``part_rows`` of the CUDA source): a group
    of G > ROWS heads is split into ceil(G / ROWS) even parts, each run by
    its own cluster over the same K/V rows; a head's bits do not depend on
    the split."""
    parts = -(-G // ROWS)
    return -(-G // parts)


def _fixed_bytes(G: int, D: int) -> int:
    """Shared memory that does not grow with the view: the threads' K/V
    staging rings (which later hold the warps' PV partials), the block's q
    rows and PV sums (f32), the stats words."""
    ring = max(RING_BYTES, (THREADS // 32) * ROWS * D * 4)
    return ring + 4 * (2 * part_rows(G) * D + STAT_WORDS)


def smem_bytes(n_keys: int, G: int, D: int) -> int:
    """Dynamic shared memory of one block for a view of ``n_keys`` keys
    (``smem_bytes`` of ``csrc/decode_attention.cu``): beside
    :func:`_fixed_bytes`, the block's share of the score row — ceil(n_keys
    / CLUSTER) keys rounded up to 4, each with ROWS f32 scores and its
    row index. It depends on the view length, G and D only, never on the
    data or on the layout of the pool."""
    share = (-(-n_keys // CLUSTER) + 3) // 4 * 4
    return _fixed_bytes(G, D) + 4 * (ROWS + 1) * share


def max_keys(G: int, D: int) -> int:
    """The longest view the kernel takes at this G and D."""
    share = (MAX_SMEM - _fixed_bytes(G, D)) // (4 * (ROWS + 1)) // 4 * 4
    return CLUSTER * share


def _check(q, q_pos, p_dtype, Hkv, n_keys, tensors):
    """Checks both kernels share: device, layout, dtypes, the group shape
    and the shared memory a view of ``n_keys`` keys needs."""
    B, S, Hq, D = q.shape
    for name, t in {"q": q, "q_pos": q_pos, **tensors}.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or (t.is_floating_point() and t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous (and 16-byte aligned if "
                             "floating)")
    if S != 1 or q_pos.shape != (B,) or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} with q_pos {tuple(q_pos.shape)} and "
                         f"{Hkv} kv heads is not a single-token GQA decode")
    if q.dtype not in _DTYPES or p_dtype not in _DTYPES:
        raise ValueError(f"q and p_dtype must be one of {list(_DTYPES)}, got "
                         f"{q.dtype} and {p_dtype}")
    G = Hq // Hkv
    if G > MAX_GROUP or D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes G <= {MAX_GROUP} query heads per kv "
                         f"head and D in {HEAD_DIMS}; got G={G}, D={D}")
    if smem_bytes(n_keys, G, D) > MAX_SMEM:
        raise ValueError(
            f"{n_keys} keys per lane need {smem_bytes(n_keys, G, D)} bytes of shared "
            f"memory per block (each of the {CLUSTER} blocks of a cluster holds its "
            f"share of the (G={G}, keys) score rows), above the {MAX_SMEM} a block "
            f"can use (at most {max_keys(G, D)} keys here)")
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on CUDA or CPU, not {q.device}")


def _launch(q, k_cache, v_cache, k_pos, q_pos, lane_rows, *, window, softcap, p_dtype):
    global LAUNCHES
    B, S, Hq, D = q.shape
    N, Sc, Hkv, _ = k_cache.shape
    if q_pos.dtype != torch.int32:
        q_pos = q_pos.to(torch.int32)
    tensors = {"k_cache": k_cache, "v_cache": v_cache, "k_pos": k_pos}
    if lane_rows is not None:
        tensors["lane_rows"] = lane_rows
        if lane_rows.dtype != torch.int32 or lane_rows.shape != (B,):
            raise ValueError(f"lane_rows must be a ({B},) int32 map of lanes to cache "
                             f"rows, got {lane_rows.dtype} {tuple(lane_rows.shape)}")
    _check(q, q_pos, p_dtype, Hkv, Sc, tensors)
    if k_cache.shape != (N, Sc, Hkv, D) or v_cache.shape != k_cache.shape \
            or k_pos.shape != (N, Sc) or (lane_rows is None and N != B):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}, k_pos {tuple(k_pos.shape)} "
                         "do not form a single-token GQA decode")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one dtype of {list(_DTYPES)}, got "
                         f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if k_pos.dtype != torch.int32:
        raise ValueError(f"k_pos must be int32 (got {k_pos.dtype})")
    out = torch.empty((B, 1, Hq, D), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_pos.data_ptr(),
            q_pos.data_ptr(), None if lane_rows is None else lane_rows.data_ptr(),
            out.data_ptr(), B, Sc, Hkv, Hq // Hkv, D,
            *_scalars(D, window, softcap, p_dtype, q.dtype))
    with torch.cuda.device(q.device):
        rc = _kernel("repro_decode_attention", 7, 5)(
            *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
