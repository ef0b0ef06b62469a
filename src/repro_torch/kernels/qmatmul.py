"""bf16 FMAC matmul: bf16 inputs, f32 accumulation, one output rounding to
bf16 — nearest, or stochastic from caller bits (the paper's Table-1 unit).

Replaces the Pallas kernel ``repro/kernels/qmatmul.py:22``
(``qmatmul_kernel``) and its wrapper ``:46`` (``qmatmul``) with a CUDA
kernel written for Hopper, ``csrc/qmatmul.cu``, the f32 accumulators in
registers across the whole K loop and each K stage's dot added with one
rounded f32 add (as the TPU kernel adds each K tile's dot into its VMEM
accumulator), then one rounding per output. Two paths (:func:`plan`):
``"wgmma"`` — a persistent grid, TMA loads into an mbarrier ring, one
producer warp and two consumer warpgroups running ``wgmma`` from shared
memory, promotion every 128 of K — for every shape TMA can describe (K and
N multiples of 8, x, y and bits 16-byte aligned), and
``"mma.sync"`` (``mma.sync`` tiles from a ``cp.async`` ring, promotion every
32 of K) for the rest. The path and every tile choice depend on N, K and
alignment only, never on M, so a row's result is the same bits for every
row count. Operations bound it at the training shapes, bytes at the 8-row
serving shape (see the note atop the CUDA source).

The TPU wrapper's block sizes ``bm/bn/bk`` are the TPU's tiling, not part of
the function, so :func:`qmatmul` has none. Unlike the TPU kernel it takes
every shape: the CUDA kernel masks the ragged edge of M, N and K itself.
Bits are u32 carried in an int32 tensor, as in :mod:`.sr_cast`.

:func:`qmatmul_f32` is the kernel's f32-result entry: the same paths and
K chain, the accumulators written instead of rounded, so its result
rounded to bf16 is :func:`qmatmul`'s bit for bit, rows independent of M.
It computes the f32 partial sums of a row-parallel product under tensor
parallelism (:mod:`repro_torch.dist.axes`), which the model group sums and
rounds once.

CUDA tensors launch the kernel (or raise); only CPU tensors take the plain
PyTorch version :func:`qmatmul_ref`, which the tests and ``chip_smoke.py``
hold the kernel against. The tensor cores sum a group of exact products in
a wide fixed-point alignment, not by a chain of rounded f32 adds, so kernel
and plain version agree to within an f32 ulp of the accumulator, not bit
for bit: after the rounding, at most 1 bf16 ulp on a small fraction of the
outputs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sr_cast import sr_to_bf16

__all__ = ["LAUNCHES", "F32_LAUNCHES", "Plan", "plan", "qmatmul", "qmatmul_f32", "qmatmul_ref"]

MAX_M = 65535 * 128        # grid rows (blockIdx.y) x the mma.sync path's 128-row tile
MAX_NK = 2**31 - 1         # N and K are int32 inside the kernels

# Kernel launches made by qmatmul and by qmatmul_f32 (incremented per launch).
LAUNCHES = 0
F32_LAUNCHES = 0


def qmatmul_ref(x: torch.Tensor, y: torch.Tensor, *, bits: torch.Tensor | None = None,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version: the bf16 operands' product in full f32, then
    the nearest cast, or SR with ``bits`` (a non-finite accumulator takes the
    nearest cast). ``repro/kernels/ref.py::qmatmul_ref``. ``out_dtype=
    torch.float32`` returns the f32 product unrounded (the plain version of
    :func:`qmatmul_f32`; no bits)."""
    acc = x.to(torch.bfloat16).float() @ y.to(torch.bfloat16).float()
    if out_dtype == torch.float32:
        if bits is not None:
            raise ValueError("the f32 result takes no rounding bits")
        return acc
    if out_dtype != torch.bfloat16:
        raise ValueError(f"qmatmul_ref returns bf16 or f32, not {out_dtype}")
    return acc.to(torch.bfloat16) if bits is None else sr_to_bf16(acc, bits)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How ``csrc/qmatmul.cu`` computes a product: its path, output tile
    (rows x columns) and the K depth of each promotion into the f32
    accumulator."""
    path: str              # "wgmma" or "mma.sync"
    tile: tuple[int, int]
    promote: int


def plan(x: torch.Tensor, y: torch.Tensor, bits: torch.Tensor | None = None) -> Plan:
    """The kernel's choice for these operands (``choose_path`` in the CUDA
    source): a function of N, K and the base alignments only, never of M."""
    K, N = y.shape
    wgmma = (K > 0 and K % 8 == 0 and N % 8 == 0 and x.data_ptr() % 16 == 0
             and y.data_ptr() % 16 == 0 and (bits is None or bits.data_ptr() % 16 == 0))
    return Plan("wgmma", (128, 128), 128) if wgmma else Plan("mma.sync", (128, 128), 32)


def qmatmul(x: torch.Tensor, y: torch.Tensor, *, bits: torch.Tensor | None = None
            ) -> torch.Tensor:
    """``x`` (M,K) bf16 @ ``y`` (K,N) bf16 → (M,N) bf16 with f32
    accumulation and one rounding: nearest, or stochastic with ``bits``
    (int32 carrying u32, shape (M,N)). CPU tensors take the plain version."""
    _check(x, y, bits)
    if x.device.type == "cpu":
        return qmatmul_ref(x, y, bits=bits)
    return _launch(x, y, bits)


def qmatmul_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x`` (M,K) bf16 @ ``y`` (K,N) bf16 → (M,N) f32: the accumulators
    :func:`qmatmul` rounds, unrounded (nearest's path; :func:`plan` with no
    bits gives it). CPU tensors take the plain version."""
    _check(x, y, None)
    if x.device.type == "cpu":
        return qmatmul_ref(x, y, out_dtype=torch.float32)
    return _launch(x, y, None, entry="repro_qmatmul_f32")


def _check(x, y, bits):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qmatmul runs on CUDA or CPU, not {x.device}")
    named = {"x": x, "y": y} if bits is None else {"x": x, "y": y, "bits": bits}
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16:
        raise ValueError(f"qmatmul takes bf16 x and y, got {x.dtype}/{y.dtype}")
    if x.shape[1] != y.shape[0]:
        raise ValueError(f"inner dimensions differ: x {tuple(x.shape)}, y {tuple(y.shape)}")
    if bits is not None:
        if bits.dtype != torch.int32:
            raise ValueError(f"bits must be int32 carrying u32, got {bits.dtype}")
        if bits.shape != (x.shape[0], y.shape[1]):
            raise ValueError(f"bits has shape {tuple(bits.shape)}, expected "
                             f"{(x.shape[0], y.shape[1])}")


# the f32-result entries take no bits pointer
_F32_ENTRIES = ("repro_qmatmul_f32", "repro_qmatmul_f32_sync")


@functools.cache
def _kernel(entry: str = "repro_qmatmul"):
    fn = getattr(_build.load("qmatmul"), entry)
    fn.restype = ctypes.c_int
    n_ptr = 3 if entry in _F32_ENTRIES else 4
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    return fn


@functools.cache
def _path_fn():
    fn = _build.load("qmatmul").repro_qmatmul_path
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
    return fn


def kernel_path(x: torch.Tensor, y: torch.Tensor, bits: torch.Tensor | None = None) -> str:
    """The path the built CUDA library takes for these operands (it builds
    the library): what :func:`plan` must agree with."""
    (M, K), N = x.shape, y.shape[1]
    wgmma = _path_fn()(x.data_ptr(), y.data_ptr(), None if bits is None else bits.data_ptr(),
                       M, N, K)
    return "wgmma" if wgmma else "mma.sync"


def _launch(x, y, bits, *, entry: str = "repro_qmatmul"):
    """One launch. ``entry="repro_qmatmul_sync"`` (``"repro_qmatmul_f32_sync"``)
    forces the mma.sync path, which ``chip_smoke.py`` times beside the
    chosen path on the same inputs; the ``_f32`` entries write f32."""
    global LAUNCHES, F32_LAUNCHES
    for name, t in {"x": x, "y": y, "bits": bits}.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (row-major)")
    (M, K), N = x.shape, y.shape[1]
    if M > MAX_M or max(N, K) > MAX_NK:
        raise ValueError(f"qmatmul takes at most {MAX_M} rows and N, K up to {MAX_NK}, "
                         f"got {(M, N, K)}")
    f32 = entry in _F32_ENTRIES
    out = torch.empty((M, N), dtype=torch.float32 if f32 else torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    ptrs = [x.data_ptr(), y.data_ptr()]
    if not f32:
        ptrs.append(None if bits is None else bits.data_ptr())
    with torch.cuda.device(x.device):
        rc = _kernel(entry)(*ptrs, out.data_ptr(), M, N, K,
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qmatmul kernel launch failed: CUDA error {rc}")
    if f32:
        F32_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out
