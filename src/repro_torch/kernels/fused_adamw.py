"""Fused AdamW update (the paper's Algorithms 4/5) with nearest or SR weight
rounding and optional Kahan compensation.

Replaces the Pallas kernel ``repro/kernels/fused_adamw.py:36``
(``fused_adamw_kernel``) and its wrapper ``:90`` (``fused_adamw``) with a
CUDA kernel written for Hopper, ``csrc/fused_adamw.cu``: one pass over
w, m, v, g (and c) in bf16, 8 elements a thread in 16-byte vectors, the
whole update in f32 registers, every FPU output rounded once to bf16 in the
reference's op order. The SR bits are either drawn inside the kernel from
the leaf's Philox stream (``seed=``; :mod:`.philox`, the optimizers'
``StepKey``) or read from an int32 tensor (``bits=``; ``GivenKey`` and the
op layer). Bytes bound it: 18 per element for seeded SR + Kahan (see the
CUDA source; :func:`probe` times the same kernel's loads alone and its
loads and stores alone).

Unlike the reference's functional API, :func:`fused_adamw` updates
**in place**: w, m, v and c are overwritten (each element read, then
written, by the same thread), so the optimizer never holds a second copy
of its state — 18.5 GB at full-width qwen2.5-3b. It takes tensors of any
shape and length; nothing is padded or copied.

The scalars are f32: ``1 - b1``, ``1 - b2`` and ``lr * wd`` are formed in
f32 as the TPU kernel does, ``1 - c1`` and ``1 - c2`` in f32 on the host as
its wrapper does. CUDA tensors launch the kernel (or raise); only CPU tensors
take the plain PyTorch version :func:`fused_adamw_ref`, which the tests
and ``chip_smoke.py`` hold the kernel against bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.formats import sqrt_rn
from repro_torch.kernels import _build
from repro_torch.kernels.philox import philox_bits_ref, split_seed
from repro_torch.kernels.sr_cast import check_flat, sr_to_bf16

__all__ = ["LAUNCHES", "fused_adamw", "fused_adamw_ref", "probe"]

# Kernel launches made by fused_adamw (incremented per launch).
LAUNCHES = 0


def _f32(x) -> float:
    """A scalar (number or 0-dim tensor) rounded to f32, as a Python float."""
    return float(np.float32(float(x)))


def _one_minus(c) -> float:
    """``1 - c`` in f32 (the wrapper's ``1.0 - c1`` on the optimizer's f32
    ``c1``)."""
    return float(np.float32(1.0) - np.float32(float(c)))


def fused_adamw_ref(w, m, v, g, *, c=None, bits=None, seed=None, lr, b1, b2, eps, wd,
                    c1, c2, stochastic=True):
    """Plain PyTorch version, in the kernel's op order; returns new tensors
    ``(w', m', v', c')`` (``c'`` None without Kahan). With ``seed`` the SR
    bits are the leaf's Philox words (:func:`~.philox.philox_bits_ref`)."""
    if seed is not None:
        bits = philox_bits_ref(seed, w.numel(), w.device).reshape(w.shape)
    f32 = lambda a: a.to(torch.float32)               # noqa: E731
    bf = lambda a: a.to(torch.bfloat16)                # noqa: E731
    lr, b1, b2, eps, wd = (np.float32(float(s)) for s in (lr, b1, b2, eps, wd))
    om_b1, om_b2, lr_wd = float(np.float32(1) - b1), float(np.float32(1) - b2), float(lr * wd)
    lr, b1, b2, eps = float(lr), float(b1), float(b2), float(eps)
    # divisors as device tensors: CUDA divides by a CPU scalar through its
    # reciprocal, which is not the kernel's division
    om_c1 = torch.tensor(_one_minus(c1), dtype=torch.float32, device=w.device)
    om_c2 = torch.tensor(_one_minus(c2), dtype=torch.float32, device=w.device)
    wf, gf = f32(w), f32(g)
    m2 = bf(b1 * f32(m) + om_b1 * gf)
    v2 = bf(b2 * f32(v) + om_b2 * gf * gf)
    m_hat = f32(bf(f32(m2) / om_c1))
    v_hat = f32(bf(sqrt_rn(f32(v2) / om_c2)))
    u = f32(bf(lr * m_hat / (v_hat + eps) + lr_wd * wf))
    w2, c2 = update_weight(w, wf, u, c, bits, stochastic)
    return w2, m2, v2, c2


def update_weight(w, wf, u, c, bits, stochastic):
    """``w - u`` (nearest or SR), or the Kahan update with compensation c
    (Alg. 3/5 lines: y = bf(bf(−u) − c), s = round(w + y),
    c = bf(bf(s − w) − y)). Returns ``(w', c')``."""
    f32 = lambda a: a.to(torch.float32)               # noqa: E731
    bf = lambda a: a.to(torch.bfloat16)                # noqa: E731
    rnd = (lambda x: sr_to_bf16(x, bits)) if stochastic else bf
    if c is None:
        return rnd(wf - u), None
    y = f32(bf(f32(bf(-u)) - f32(c)))
    s = rnd(wf + y)
    return s, bf(f32(bf(f32(s) - wf)) - y)


def fused_adamw(w, m, v, g, *, c=None, bits=None, seed=None, lr, b1, b2, eps, wd,
                c1, c2, stochastic: bool = True):
    """One AdamW step on tensors of any shape, **in place**: w, m, v (and c,
    the Kahan buffer, when given) are overwritten and returned as
    ``(w, m, v, c)``. When ``stochastic`` the SR rounding takes its bits
    from the leaf's Philox stream of ``seed`` (drawn inside the kernel) or
    from ``bits`` (int32 carrying u32, w's shape): exactly one is given.
    w, m, v, c, g are bf16."""
    if stochastic and (bits is None) == (seed is None):
        raise ValueError("stochastic rounding needs bits or a seed (one of them)")
    if not stochastic:
        bits = seed = None
    if w.device.type == "cpu":
        out = fused_adamw_ref(w, m, v, g, c=c, bits=bits, seed=seed, lr=lr, b1=b1,
                              b2=b2, eps=eps, wd=wd, c1=c1, c2=c2, stochastic=stochastic)
        for dst, src in zip((w, m, v, c), out):
            if dst is not None:
                dst.copy_(src)
        return w, m, v, c
    _launch(w, m, v, g, c, bits, seed, stochastic,
            (_f32(lr), _f32(b1), _f32(b2), _f32(eps), _f32(wd), _one_minus(c1),
             _one_minus(c2)))
    return w, m, v, c


@functools.cache
def _kernel():
    fn = _build.load("fused_adamw").repro_fused_adamw
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_uint] * 2
                   + [ctypes.c_float] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return fn


@functools.cache
def _probe_kernel():
    fn = _build.load("fused_adamw").repro_fused_adamw_probe
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_void_p])
    return fn


def _check(w, m, v, g, c, bits=None):
    tensors = {"w": w, "m": m, "v": v, "g": g}
    if c is not None:
        tensors["c"] = c
    check_flat(tensors, w)
    if any(t.dtype != torch.bfloat16 for t in tensors.values()):
        raise ValueError("fused_adamw takes bf16 w, m, v, g, c; got "
                         + ", ".join(f"{k} {t.dtype}" for k, t in tensors.items()))
    if bits is not None:
        check_flat({"bits": bits}, w)
        if bits.dtype != torch.int32:
            raise ValueError(f"bits must be int32 carrying u32, got {bits.dtype}")


def _launch(w, m, v, g, c, bits, seed, stochastic, scalars):
    global LAUNCHES
    _check(w, m, v, g, c, bits)
    key = split_seed(seed) if seed is not None else (0, 0)
    with torch.cuda.device(w.device):
        rc = _kernel()(w.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                       None if c is None else c.data_ptr(),
                       None if bits is None else bits.data_ptr(), w.numel(), *key,
                       *scalars, int(stochastic), int(c is not None), int(seed is not None),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_adamw kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1


def probe(variant: str, w, m, v, g, c) -> None:
    """A part of the seeded SR + Kahan kernel alone, for measuring what
    bounds it: ``"loads"`` reads w, m, v, g, c and writes nothing;
    ``"loads+stores"`` also writes w, m, v, c back unchanged. CUDA tensors
    only; not counted in ``LAUNCHES``."""
    code = {"loads": 1, "loads+stores": 2}[variant]
    _check(w, m, v, g, c)
    sink = torch.empty((4,), dtype=torch.int32, device=w.device)
    with torch.cuda.device(w.device):
        rc = _probe_kernel()(code, w.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                             c.data_ptr(), sink.data_ptr(), w.numel(),
                             torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_adamw probe launch failed: CUDA error {rc}")
