"""Fused single-token decode attention over the contiguous slotted KV pool
and over the paged KV pool.

Replaces the Pallas kernels ``repro/kernels/decode_attention.py:42``
(``decode_attention_kernel``, wrapper ``:71`` ``fused_decode_attention``)
and ``:102`` (``paged_decode_attention_kernel``, wrapper ``:148``
``fused_paged_decode_attention``) with one CUDA kernel body written for
Hopper, ``csrc/decode_attention.cu``, entered through two C functions
that differ only in how a key index becomes a row of K/V: ``b·Sc + key``
for the contiguous pool, ``table[b, key // P]·P + key % P`` for the
paged pool. Per lane, in the reference's op order: f32
scores ``q.k / sqrt(D)``, optional softcap tanh, the mask
``0 <= k_pos <= q_pos`` (plus the window), a full-row softmax, the
probabilities cast to ``p_dtype``, PV accumulated in f32, an unrounded f32
output (the caller rounds once). A parked lane (``q_pos < 0``) gives zeros.

What bounds it on an H100 is the bytes of K, V and ``k_pos`` it reads, not
its flops. The kernel reads each K/V row once for the G query heads of its
kv-head (one block per lane and kv-head) and skips the K/V rows of masked
cells, so empty pool cells cost nothing; the score rows stay in shared
memory. See the note at the top of the CUDA source.

:func:`fused_decode_attention` and :func:`fused_paged_decode_attention`
launch the kernel for CUDA tensors and raise if they cannot; only for CPU
tensors do they run the plain PyTorch versions :func:`decode_attention_ref`
and :func:`paged_decode_attention_ref`, which the tests and
``chip_smoke.py`` hold the kernel against. Sharing the body makes the
paged kernel on a pool bitwise equal to the contiguous kernel on the
gathered view ``pages[block_table]``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "PAGED_LAUNCHES", "decode_attention_ref",
           "fused_decode_attention", "paged_decode_attention_ref",
           "fused_paged_decode_attention"]

NEG_INF = -1e30
THREADS = 1024         # kThreads in csrc/decode_attention.cu
MAX_GROUP = 8          # kMaxGroup
MAX_SMEM = 232448      # the 227 KB of shared memory a block may opt into
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# Kernel launches made by fused_decode_attention and by
# fused_paged_decode_attention (each incremented per launch).
LAUNCHES = 0
PAGED_LAUNCHES = 0


def decode_attention_ref(q, k_cache, v_cache, k_pos, q_pos, *, window=None,
                         softcap=None, p_dtype=torch.bfloat16):
    """Plain PyTorch version, in ``repro.models.layers.decode_attention``'s
    op order (S=1). q: (B,1,Hq,D); caches: (B,Sc,Hkv,D); k_pos: (B,Sc) i32;
    q_pos: (B,) i32, −1 ⇒ parked lane (zeros). Returns f32 (B,1,Hq,D)."""
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


def fused_decode_attention(q, k_cache, v_cache, k_pos, q_pos, *, window=None,
                           softcap=None, p_dtype=torch.bfloat16):
    """The decode kernel: q (B,1,Hq,D); caches (B,Sc,Hkv,D) bf16 or f32;
    k_pos (B,Sc) i32; q_pos (B,) (−1 ⇒ parked lane). Returns f32
    (B,1,Hq,D), unrounded. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, k_pos, q_pos,
                                    window=window, softcap=softcap,
                                    p_dtype=p_dtype)
    return _launch(q, k_cache, v_cache, k_pos, q_pos, window=window,
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


def _check(q, q_pos, p_dtype, Hkv, n_keys, tensors):
    """Checks both kernels share: device, layout, dtypes, the group shape
    and the shared memory the (G, n_keys) score rows need."""
    B, S, Hq, D = q.shape
    for name, t in {"q": q, "q_pos": q_pos, **tensors}.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or (t.is_floating_point() and t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous (and 16-byte aligned if "
                             "floating)")
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on CUDA or CPU, not {q.device}")
    if S != 1 or q_pos.shape != (B,) or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} with q_pos {tuple(q_pos.shape)} and "
                         f"{Hkv} kv heads is not a single-token GQA decode")
    if q.dtype not in _DTYPES or p_dtype not in _DTYPES:
        raise ValueError(f"q and p_dtype must be one of {list(_DTYPES)}, got "
                         f"{q.dtype} and {p_dtype}")
    G = Hq // Hkv
    if G > MAX_GROUP or D % 32 or (2 * THREADS) % D:
        raise ValueError(f"the kernel takes G <= {MAX_GROUP} query heads per kv "
                         f"head and D a multiple of 32 dividing {2 * THREADS}; "
                         f"got G={G}, D={D}")
    fixed = G * D + (2 * THREADS - D) * G          # q rows + PV partial sums
    if 4 * (fixed + (G + 1) * n_keys) > MAX_SMEM:
        raise ValueError(
            f"{n_keys} keys per lane need {4 * (fixed + (G + 1) * n_keys)} bytes of "
            f"shared memory for the (G={G}, keys) score rows, above the {MAX_SMEM} a "
            f"block can use; the kernel holds full score rows (at most "
            f"{(MAX_SMEM // 4 - fixed) // (G + 1)} keys here)")


def _launch(q, k_cache, v_cache, k_pos, q_pos, *, window, softcap, p_dtype):
    global LAUNCHES
    B, S, Hq, D = q.shape
    _, Sc, Hkv, _ = k_cache.shape
    if q_pos.dtype != torch.int32:
        q_pos = q_pos.to(torch.int32)
    _check(q, q_pos, p_dtype, Hkv, Sc,
           {"k_cache": k_cache, "v_cache": v_cache, "k_pos": k_pos})
    if k_cache.shape != (B, Sc, Hkv, D) or v_cache.shape != k_cache.shape \
            or k_pos.shape != (B, Sc):
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
            q_pos.data_ptr(), out.data_ptr(), B, Sc, Hkv, Hq // Hkv, D,
            *_scalars(D, window, softcap, p_dtype, q.dtype))
    with torch.cuda.device(q.device):
        rc = _kernel("repro_decode_attention", 6, 5)(
            *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
