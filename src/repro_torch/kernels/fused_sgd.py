"""Fused SGD-momentum update (the paper's Algorithms 2/3) with nearest or SR
weight rounding and optional Kahan compensation.

Replaces the Pallas kernel ``repro/kernels/fused_sgd.py:18``
(``fused_sgd_kernel``) and its wrapper ``:47`` (``fused_sgd``) with a CUDA
kernel written for Hopper, ``csrc/fused_sgd.cu``: ``g = bf(g + wd·w)``,
``m = bf(μ·m + g)``, ``u = bf(lr·m)``, then the weight update of
:func:`repro_torch.kernels.fused_adamw.update_weight`. Bytes bound it (18
per element for SR+Kahan). Like :func:`fused_adamw`, it updates w, m and c
**in place**, on tensors of any shape. CUDA tensors launch the kernel (or
raise); only CPU tensors take the plain version :func:`fused_sgd_ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_adamw import _f32, update_weight
from repro_torch.kernels.sr_cast import check_flat

__all__ = ["LAUNCHES", "fused_sgd", "fused_sgd_ref"]

# Kernel launches made by fused_sgd (incremented per launch).
LAUNCHES = 0


def fused_sgd_ref(w, m, g, *, c=None, bits=None, lr, momentum=0.9, wd=0.0,
                  stochastic=True):
    """Plain PyTorch version, in the kernel's op order; returns new tensors
    ``(w', m', c')`` (``c'`` None without Kahan)."""
    f32 = lambda a: a.to(torch.float32)               # noqa: E731
    bf = lambda a: a.to(torch.bfloat16)                # noqa: E731
    lr, mu, wd = (_f32(s) for s in (lr, momentum, wd))
    wf = f32(w)
    gf = f32(bf(f32(g) + wd * wf))
    m2 = bf(mu * f32(m) + gf)
    u = f32(bf(lr * f32(m2)))
    w2, c2 = update_weight(w, wf, u, c, bits, stochastic)
    return w2, m2, c2


def fused_sgd(w, m, g, *, c=None, bits=None, lr, momentum=0.9, wd=0.0,
              stochastic: bool = True):
    """One SGD-momentum step on tensors of any shape, **in place**: w, m
    (and c, the Kahan buffer, when given) are overwritten and returned as
    ``(w, m, c)``. ``bits`` (int32 carrying u32) drive SR when
    ``stochastic``. w, m, g, c are bf16."""
    if stochastic and bits is None:
        raise ValueError("stochastic rounding needs bits")
    if w.device.type == "cpu":
        out = fused_sgd_ref(w, m, g, c=c, bits=bits, lr=lr, momentum=momentum,
                            wd=wd, stochastic=stochastic)
        for dst, src in zip((w, m, c), out):
            if dst is not None:
                dst.copy_(src)
        return w, m, c
    _launch(w, m, g, c, bits if stochastic else None,
            (_f32(lr), _f32(momentum), _f32(wd)))
    return w, m, c


@functools.cache
def _kernel():
    fn = _build.load("fused_sgd").repro_fused_sgd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_float] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return fn


def _launch(w, m, g, c, bits, scalars):
    global LAUNCHES
    tensors = {"w": w, "m": m, "g": g}
    if c is not None:
        tensors["c"] = c
    check_flat(tensors, w)
    if any(t.dtype != torch.bfloat16 for t in tensors.values()):
        raise ValueError("fused_sgd takes bf16 w, m, g, c; got "
                         + ", ".join(f"{k} {t.dtype}" for k, t in tensors.items()))
    if bits is not None:
        check_flat({"bits": bits}, w)
        if bits.dtype != torch.int32:
            raise ValueError(f"bits must be int32 carrying u32, got {bits.dtype}")
    with torch.cuda.device(w.device):
        rc = _kernel()(w.data_ptr(), m.data_ptr(), g.data_ptr(),
                       None if c is None else c.data_ptr(),
                       None if bits is None else bits.data_ptr(), w.numel(), *scalars,
                       int(bits is not None), int(c is not None),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_sgd kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1

