"""Mean of squares of each row in an order fixed by the row length: the f32
reduction of RMSNorm in the serve step.

No TPU kernel is replaced: the reference takes ``jnp.mean(jnp.square(x))``
over d_model (``repro/core/qarith.py::QArith.rmsnorm``). On the card
``torch.mean`` chooses how to split a row from the number of rows, so a
row's sum, and every bit after it, could depend on how many rows a serve
step carries (ROADMAP C10). ``csrc/row_mean_sq.cu`` gives each row one warp:
lane l sums the squares of elements l, l + 32, ... in ascending order, the
32 lane sums meet in a butterfly (xor 16, 8, 4, 2, 1), and the sum is
divided by D — an order that depends on D only.

:func:`row_mean_sq` launches the kernel for CUDA tensors and raises if it
cannot; only for CPU tensors does it run the plain PyTorch version
:func:`row_mean_sq_ref`, which sums in the kernel's order, so the two are
equal bit for bit (``chip_smoke.py`` holds them so on the card).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "row_mean_sq", "row_mean_sq_ref"]

WARP = 32
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# Kernel launches made by row_mean_sq (incremented per launch).
LAUNCHES = 0


def row_mean_sq_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``x`` (..., D) → f32 (..., 1), the mean of
    x² over the last axis, summed in the kernel's order: per lane a chain
    of f32 adds over its strided elements (zero padding past D adds +0,
    which changes no sum of squares), then the butterfly, then ÷ D."""
    D = x.shape[-1]
    sq = x.reshape(-1, D).to(torch.float32)
    sq = sq * sq
    sq = F.pad(sq, (0, -D % WARP)).reshape(sq.shape[0], -1, WARP)
    acc = sq[:, 0]
    for k in range(1, sq.shape[1]):
        acc = acc + sq[:, k]
    lane = torch.arange(WARP, device=x.device)
    for s in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ s]
    # a tensor divisor: CUDA divides by a Python scalar through its reciprocal
    mean = acc[:, :1] / torch.full_like(acc[:, :1], float(D))
    return mean.reshape(*x.shape[:-1], 1)


def row_mean_sq(x: torch.Tensor) -> torch.Tensor:
    """Mean of x² over the last axis of bf16 or f32 ``x`` (..., D), as f32
    (..., 1). CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return row_mean_sq_ref(x)
    return _launch(x)


@functools.cache
def _kernel():
    fn = _build.load("row_mean_sq").repro_row_mean_sq
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    return fn


def _launch(x: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"row_mean_sq runs on CUDA or CPU, not {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"row_mean_sq takes bf16 or f32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    D = x.shape[-1]
    rows = x.numel() // max(D, 1)
    out = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), out.data_ptr(), rows, D, _DTYPES[x.dtype],
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"row_mean_sq kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
