"""The stochastic-rounding bits of a parameter leaf from Philox4x32-10.

No TPU kernel is replaced: the reference draws its SR bits with
``jax.random.bits`` from a key split per leaf (``repro/optim/base.py``),
and the port keys a counter-based generator instead, so that a kernel can
draw the bits itself (``csrc/philox.cuh``). The stream of a leaf with the
64-bit seed s: key = (s & 0xffffffff, s >> 32); element i takes word i % 4
of the block j = i // 4, whose counter is (j & 0xffffffff, j >> 32, 0, 0).

:func:`philox_bits` fills an int32 tensor (carrying u32) with those words:
``csrc/philox.cu`` for a CUDA device, raising if it cannot launch; the plain
PyTorch version :func:`philox_bits_ref` only for the CPU. Given a
``full_shape``, it fills a shard of the leaf instead (FSDP): the slice of
``dim`` from ``start``, each element taking the word of its position in
the full leaf (the kernel's second entry; plain: :func:`philox_bits_at`). ``fused_adamw``
draws the same words inside its kernel, so every optimizer sees the same
bits for one seed. The plain version works in int64, every value masked to
32 bits, and forms the high and low words of a 32×32-bit product from two
products of at most 48 bits, so no int64 operation overflows.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "philox4x32_10", "philox_bits", "philox_bits_ref", "philox_bits_at",
           "split_seed"]

M32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # key bumps

# Kernel launches made by philox_bits (incremented per launch).
LAUNCHES = 0


def split_seed(seed: int) -> tuple[int, int]:
    """The Philox key of a 64-bit seed: (low word, high word)."""
    seed = int(seed) & ((1 << 64) - 1)
    return seed & M32, seed >> 32


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``m * x`` (m < 2³², x int64 < 2³²),
    from the two partial products m·x_lo and m·x_hi of at most 48 bits."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & M32
    return hi, lo


def philox4x32_10(ctr, key) -> list[torch.Tensor]:
    """Philox4x32-10 on int64 tensors of counters: ``ctr`` four tensors (or
    ints) of one shape holding u32 values, ``key`` two ints (or int64
    tensors holding u32 that broadcast against the counters: one key per
    row of a batch of streams). Returns the four output words as int64
    tensors holding u32."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = (k & M32 if isinstance(k, torch.Tensor) else int(k) & M32 for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & M32, (k1 + _W1) & M32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def philox_bits_ref(seed: int, n: int, device=None) -> torch.Tensor:
    """Plain PyTorch version: the (n,) int32 words of the leaf stream of
    ``seed`` (word i of the stream at element i)."""
    j = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    words = torch.stack(philox4x32_10((j & M32, j >> 32, 0, 0), split_seed(seed)), dim=1)
    words = words.reshape(-1)[:n]
    return torch.where(words > 0x7FFFFFFF, words - (1 << 32), words).to(torch.int32)


def _slice_geometry(shape, full_shape, dim: int, start: int) -> tuple[int, int, int]:
    """(run length, row stride, first index) of the shard of ``shape`` at
    ``start`` along ``dim`` of a leaf of ``full_shape``: element k of the
    shard is element (k // run) * stride + first + k % run of the leaf."""
    shape, full_shape = tuple(int(s) for s in shape), tuple(int(s) for s in full_shape)
    if len(shape) != len(full_shape) or any(
            a != b for i, (a, b) in enumerate(zip(shape, full_shape)) if i != dim) \
            or not 0 <= start <= full_shape[dim] - shape[dim]:
        raise ValueError(f"a {shape} shard at {start} of dim {dim} does not lie in a "
                         f"{full_shape} leaf")
    inner = math.prod(shape[dim + 1:])
    return shape[dim] * inner, full_shape[dim] * inner, start * inner


def philox_bits_at(seed: int, index: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the int32 words of the leaf stream of ``seed``
    at the element positions ``index`` (int64)."""
    j = index // 4
    words = torch.stack(philox4x32_10((j & M32, j >> 32, 0, 0), split_seed(seed)))
    words = words.gather(0, (index % 4)[None])[0]
    return torch.where(words > 0x7FFFFFFF, words - (1 << 32), words).to(torch.int32)


def philox_bits(seed: int, shape, device, *, full_shape=None, dim: int = 0,
                start: int = 0) -> torch.Tensor:
    """The SR bits of the leaf stream of ``seed`` as an int32 tensor of
    ``shape`` on ``device`` (row-major element order); with ``full_shape``,
    of the shard of that leaf that starts at ``start`` along ``dim``. CPU
    devices take the plain version."""
    device = torch.device(device)
    n = math.prod(int(s) for s in shape)
    if full_shape is not None:
        run, stride, first = _slice_geometry(shape, full_shape, dim, start)
        if device.type == "cpu":
            k = torch.arange(n, dtype=torch.int64)
            return philox_bits_at(seed, (k // run) * stride + first + k % run).reshape(shape)
        return _launch(seed, shape, n, device, (run, stride, first))
    if device.type == "cpu":
        return philox_bits_ref(seed, n).reshape(shape)
    return _launch(seed, shape, n, device)


@functools.cache
def _kernel():
    fn = _build.load("philox").repro_philox_bits
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_void_p]
    return fn


@functools.cache
def _slice_kernel():
    fn = _build.load("philox").repro_philox_bits_slice
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_void_p]
    return fn


def _launch(seed, shape, n, device, geometry=None):
    global LAUNCHES
    if device.type != "cuda":
        raise ValueError(f"philox_bits runs on CUDA or CPU, not {device}")
    out = torch.empty(shape, dtype=torch.int32, device=device)
    if n == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if geometry is None:
            rc = _kernel()(out.data_ptr(), n, *split_seed(seed), stream)
        else:
            rc = _slice_kernel()(out.data_ptr(), n, *geometry, *split_seed(seed), stream)
    if rc != 0:
        raise RuntimeError(f"philox_bits kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
