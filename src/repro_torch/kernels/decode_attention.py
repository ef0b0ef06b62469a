"""Fused single-token decode attention over the contiguous slotted KV pool.

Replaces the Pallas kernel ``repro/kernels/decode_attention.py:42``
(``decode_attention_kernel``) and its wrapper ``:71``
(``fused_decode_attention``) with a CUDA kernel written for Hopper,
``csrc/decode_attention.cu``. Per lane, in the reference's op order: f32
scores ``q.k / sqrt(D)``, optional softcap tanh, the mask
``0 <= k_pos <= q_pos`` (plus the window), a full-row softmax, the
probabilities cast to ``p_dtype``, PV accumulated in f32, an unrounded f32
output (the caller rounds once). A parked lane (``q_pos < 0``) gives zeros.

What bounds it on an H100 is the bytes of K, V and ``k_pos`` it reads, not
its flops. The kernel reads each K/V row once for the G query heads of its
kv-head (one block per lane and kv-head) and skips the K/V rows of masked
cells, so empty pool cells cost nothing; the score rows stay in shared
memory. See the note at the top of the CUDA source.

:func:`fused_decode_attention` launches the kernel for CUDA tensors and
raises if it cannot; only for CPU tensors does it run the plain PyTorch
version :func:`decode_attention_ref`, which the tests and ``chip_smoke.py``
hold the kernel against.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "decode_attention_ref", "fused_decode_attention"]

NEG_INF = -1e30
THREADS = 1024         # kThreads in csrc/decode_attention.cu
MAX_GROUP = 8          # kMaxGroup
MAX_SMEM = 232448      # the 227 KB of shared memory a block may opt into
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# Kernel launches made by fused_decode_attention (incremented per launch).
LAUNCHES = 0


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


@functools.cache
def _kernel():
    """The kernel's C entry point, built and loaded at first use."""
    fn = _build.load("decode_attention").repro_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    return fn


def _launch(q, k_cache, v_cache, k_pos, q_pos, *, window, softcap, p_dtype):
    global LAUNCHES
    B, S, Hq, D = q.shape
    _, Sc, Hkv, _ = k_cache.shape
    if q_pos.dtype != torch.int32:
        q_pos = q_pos.to(torch.int32)
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
               "k_pos": k_pos, "q_pos": q_pos}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on CUDA or CPU, not {q.device}")
    if S != 1 or k_cache.shape != (B, Sc, Hkv, D) or v_cache.shape != k_cache.shape \
            or k_pos.shape != (B, Sc) or q_pos.shape != (B,) or Hq % Hkv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}, k_pos {tuple(k_pos.shape)} "
                         "do not form a single-token GQA decode")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one dtype of {list(_DTYPES)}, got "
                         f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if k_pos.dtype != torch.int32 or p_dtype not in _DTYPES:
        raise ValueError(f"k_pos must be int32 (got {k_pos.dtype}) and p_dtype "
                         f"one of {list(_DTYPES)} (got {p_dtype})")
    G = Hq // Hkv
    if G > MAX_GROUP or D % 32 or (2 * THREADS) % D:
        raise ValueError(f"the kernel takes G <= {MAX_GROUP} query heads per kv "
                         f"head and D a multiple of 32 dividing {2 * THREADS}; "
                         f"got G={G}, D={D}")
    fixed = G * D + (2 * THREADS - D) * G          # q rows + PV partial sums
    if 4 * (fixed + (G + 1) * Sc) > MAX_SMEM:
        raise ValueError(
            f"cache length {Sc} needs {4 * (fixed + (G + 1) * Sc)} bytes of shared "
            f"memory for the (G={G}, Sc) score rows, above the {MAX_SMEM} a block "
            f"can use; the kernel holds full score rows (at most Sc="
            f"{(MAX_SMEM // 4 - fixed) // (G + 1)} here)")
    out = torch.empty((B, 1, Hq, D), dtype=torch.float32, device=q.device)
    fn = _kernel()
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_pos.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(), B, Sc, Hkv, G, D, 1.0 / math.sqrt(D),
            -1 if window is None else int(window), float(softcap) if softcap else 0.0,
            int(p_dtype == torch.bfloat16), _DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
