"""FMAC-model arithmetic bound to a :class:`PrecisionPolicy` (port of
``repro.core.qarith``).

Every operator takes 16-bit inputs, multiplies/accumulates in f32 and
rounds its output once. Where the contraction runs depends on the
tensors' device:

* CPU: the rounded bf16/fp16 inputs are upcast to f32 before contracting
  — exactly the reference's own CPU path (``qarith.py:40-51``), and
  bitwise equal to it.
* CUDA: the product runs in the compute dtype through cuBLAS, which
  accumulates in f32 and rounds the output once; the package disables
  cuBLAS's reduced-precision reductions (see ``repro_torch/__init__.py``).

Products whose result stays in the f32 accumulator (the reference's
``preferred_element_type=f32``: the logits, attention's scores and PV)
go through :func:`f32_product`: on CUDA, 16-bit operands run one
tensor-core GEMM with an f32 result; elsewhere the operands are upcast.

Activations and normalisations are one fused op computed in f32 and
rounded once at the output (the paper's footnote 4).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.formats import round_nearest
from repro_torch.core.policy import PrecisionPolicy

__all__ = ["QArith", "f32_product", "on_tensor_cores"]

_HALF = (torch.bfloat16, torch.float16)
_F32 = torch.float32


def on_tensor_cores(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Both operands bf16, or both fp16, on a CUDA device."""
    return a.device.type == "cuda" and a.dtype in _HALF and b.dtype == a.dtype


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batch dims broadcast) with an f32 result: the
    reference's ``preferred_element_type=f32`` dot of compute-dtype
    operands.

    On CUDA with both operands bf16 (or both fp16) it is one tensor-core
    GEMM that accumulates in f32 and returns f32 (``mm``/``bmm`` with
    ``out_dtype``), with no f32 copy of either operand: an upcast 16-bit
    value is exact, so this is the same function as the f32 product, summed
    in another order. Otherwise (the CPU, f32 operands such as the ``fp32``
    policy's or an f32 cotangent) the operands are upcast and multiplied
    in f32, as the reference does on its CPU path."""
    if not on_tensor_cores(a, b):
        return torch.matmul(a.to(_F32), b.to(_F32))
    if b.dim() == 2:                     # fold a's batch dims into its rows
        rows = a.reshape(-1, a.shape[-1])
        return torch.mm(rows, b, out_dtype=_F32).reshape(*a.shape[:-1], b.shape[-1])
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    out = torch.bmm(a3, b3, out_dtype=_F32)
    return out.reshape(*batch, a.shape[-2], b.shape[-1])


def _col_major(t: torch.Tensor) -> bool:
    return t.stride(0) == 1 and t.stride(1) == t.shape[0]


class _F32OutProduct(torch.autograd.Function):
    """``a`` (..., K) @ ``b`` (K, N) with an f32 result on the tensor cores
    (:func:`f32_product`). The backward is the arithmetic autograd runs
    through the upcast product ``torch.matmul(a.float(), b.float())``
    (``MmBackward`` on ``a`` folded to rows, each operand's layout kept),
    so the gradients are those of the f32 path bit for bit: the cotangent
    is f32, and so are its two GEMMs."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return f32_product(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        a32 = a.to(_F32).reshape(-1, a.shape[-1])
        b32 = b.to(_F32)
        g2 = g.reshape(-1, g.shape[-1])
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = b32.mm(g2.t()).t() if _col_major(a32) else g2.mm(b32.t())
            ga = ga.reshape(a.shape).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = g2.t().mm(a32).t() if _col_major(b32) else a32.t().mm(g2)
            gb = gb.to(b.dtype)
        return ga, gb


def _as(x, dtype: torch.dtype) -> torch.Tensor:
    """A tensor or Python number as a tensor of ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(x, dtype=dtype)


class QArith:
    """Operator set for one precision policy. Stateless."""

    def __init__(self, policy: PrecisionPolicy):
        self.policy = policy
        self._fmt = policy.compute_format
        self._native = policy.native or policy.compute_format.name == "fp16"

    def _fmac_in(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cast(x)
        if y.device.type == "cpu" and y.dtype in _HALF:
            return y.to(torch.float32)
        return y

    # -- casts --------------------------------------------------------------
    def cast(self, x: torch.Tensor) -> torch.Tensor:
        """Snap a value onto the compute grid (= write it through the FPU)."""
        if self._native:
            return x.to(self.policy.compute_dtype)
        return round_nearest(x, self._fmt)

    @property
    def dtype(self) -> torch.dtype:
        return self.policy.compute_dtype

    # -- FMAC-backed contractions -------------------------------------------
    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.cast(torch.matmul(self._fmac_in(a), self._fmac_in(b)))

    def einsum(self, spec: str, *args: torch.Tensor) -> torch.Tensor:
        return self.cast(torch.einsum(spec, *(self._fmac_in(a) for a in args)))

    def matmul_f32out(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Contraction left in the 32-bit accumulator (the logits): ``a``
        (..., K) @ ``b`` (K, N), rounded inputs, f32 result. On CUDA,
        16-bit operands run on the tensor cores with an f32 result (no f32
        copy of the tied embedding); elsewhere they are upcast and
        multiplied in full f32 (:func:`f32_product`)."""
        a, b = self._fmac_in(a), self._fmac_in(b)
        if on_tensor_cores(a, b):
            return _F32OutProduct.apply(a, b)
        return torch.matmul(a.to(_F32), b.to(_F32))

    # -- elementwise ops (each = one FPU op, output rounded) -----------------
    def add(self, a, b):
        return self.cast(torch.add(self._operand(a), self._operand(b)))

    def sub(self, a, b):
        return self.cast(torch.sub(self._operand(a), self._operand(b)))

    def mul(self, a, b):
        return self.cast(torch.mul(self._operand(a), self._operand(b)))

    def _operand(self, x):
        return _as(x, self.dtype if self._native else torch.float32)

    # -- fused activation / normalization (paper footnote 4) -----------------
    def act(self, fn, *args) -> torch.Tensor:
        """Apply ``fn`` in f32 internally, round the output once."""
        return self.cast(fn(*[_as(a, torch.float32) for a in args]))

    def rmsnorm(self, x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6, *, mean_sq=None) -> torch.Tensor:
        """``mean_sq`` (x → f32 mean of x² over the last axis, keepdim)
        replaces ``torch.mean`` for the reduction: the serve step passes a
        row reduction whose order does not depend on the row count."""
        # reductions in f32 (the accumulator), elementwise normalize in the
        # compute dtype: inv is rounded, then two rounded products — the
        # reference's op order, bitwise on CPU
        if mean_sq is None:
            def mean_sq(t):
                return torch.mean(torch.square(t.to(torch.float32)), dim=-1, keepdim=True)
        if not self._native:
            def _f(xf, sf):
                return xf * torch.rsqrt(mean_sq(xf) + eps) * sf
            return self.act(_f, x, scale)
        var = mean_sq(x)
        inv = torch.rsqrt(var + eps).to(self.dtype)
        return (x.to(self.dtype) * inv) * scale.to(self.dtype)

    def layernorm(self, x: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        def _mean_var(xf):
            mu = torch.mean(xf, dim=-1, keepdim=True)
            return mu, torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)

        if not self._native:
            def _f(xf, sf, bf):
                mu, var = _mean_var(xf)
                return (xf - mu) * torch.rsqrt(var + eps) * sf + bf
            return self.act(_f, x, scale, bias)
        mu, var = _mean_var(x.to(torch.float32))
        inv = torch.rsqrt(var + eps).to(self.dtype)
        mu = mu.to(self.dtype)
        return ((x.to(self.dtype) - mu) * inv * scale.to(self.dtype)
                + bias.to(self.dtype))

    def silu(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(F.silu, x)

    def gelu(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(lambda t: F.gelu(t, approximate="tanh"), x)
