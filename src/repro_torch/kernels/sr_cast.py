"""Stochastic-rounding cast f32 → bf16 from explicit random bits.

Replaces the Pallas kernel ``repro/kernels/sr_cast.py:26``
(``sr_cast_kernel``) and its wrapper ``:46`` (``sr_cast``) with a CUDA
kernel written for Hopper, ``csrc/sr_cast.cu``: add the low 16 bits of the
caller's bits to the raw f32 bits, truncate the low 16; a non-finite input
takes the nearest cast. It is what ``UpdateOps.q_sr`` launches for every
SR write onto native bf16 (the optimizer's ⊖ under ``bf16_sr*``).

Bits are u32 carried in an int32 tensor (torch's uint32 supports few ops),
which the kernel reinterprets. What bounds the kernel on an H100 is bytes:
10 per element (see the note atop the CUDA source).

:func:`sr_cast` launches the kernel for CUDA tensors and raises if it
cannot; only for CPU tensors does it run the plain PyTorch version
:func:`sr_cast_ref`, which the tests and ``chip_smoke.py`` hold the kernel
against.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "sr_cast", "sr_cast_ref", "sr_to_bf16"]

# Kernel launches made by sr_cast (incremented per launch).
LAUNCHES = 0


def sr_to_bf16(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Plain SR of f32 ``x`` to bf16 with the low 16 bits of ``bits`` (any
    integer dtype), in int32 arithmetic: the high half of ``raw + noise``
    is the high half of ``raw`` plus the carry out of the low half."""
    raw = x.contiguous().view(torch.int32)
    low = (raw & 0xFFFF) + (bits & 0xFFFF).to(torch.int32)
    high = ((raw >> 16) & 0xFFFF) + (low >> 16)
    high = torch.where(high >= 0x8000, high - 0x10000, high)
    rounded = high.to(torch.int16).view(torch.bfloat16)
    return torch.where(torch.isfinite(x), rounded, x.to(torch.bfloat16))


def sr_cast_ref(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``x`` f32 of any shape, ``bits``
    integers of its shape → bf16 of its shape."""
    return sr_to_bf16(x.to(torch.float32), bits)


def sr_cast(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """SR-cast ``x`` (f32) to bf16 with ``bits`` (int32 carrying u32, same
    shape). CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return sr_cast_ref(x, bits)
    return _launch(x, bits)


@functools.cache
def _kernel():
    fn = _build.load("sr_cast").repro_sr_cast
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    return fn


def check_flat(names_tensors: dict, like: torch.Tensor) -> None:
    """The checks every update kernel makes: one CUDA device, contiguous,
    and as many elements as ``like``."""
    if like.device.type != "cuda":
        raise ValueError(f"the update kernels run on CUDA or CPU, not {like.device}")
    for name, t in names_tensors.items():
        if t.device != like.device:
            raise ValueError(f"{name} is on {t.device}, expected {like.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() != like.numel():
            raise ValueError(f"{name} has {t.numel()} elements, expected {like.numel()}")


def _launch(x, bits):
    global LAUNCHES
    check_flat({"x": x, "bits": bits}, x)
    if x.dtype != torch.float32 or bits.dtype != torch.int32:
        raise ValueError(f"sr_cast takes f32 x and int32 bits, got {x.dtype}/{bits.dtype}")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), bits.data_ptr(), out.data_ptr(), x.numel(),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sr_cast kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
