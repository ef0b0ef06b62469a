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

Activations and normalisations are one fused op computed in f32 and
rounded once at the output (the paper's footnote 4).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.formats import round_nearest
from repro_torch.core.policy import PrecisionPolicy

__all__ = ["QArith"]

_HALF = (torch.bfloat16, torch.float16)


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
        """Contraction left in the 32-bit accumulator (the logits). The
        rounded inputs are upcast and multiplied in full f32 on every
        device: a bf16 product would round the output."""
        return torch.matmul(self._fmac_in(a).to(torch.float32),
                            self._fmac_in(b).to(torch.float32))

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
                eps: float = 1e-6) -> torch.Tensor:
        # reductions in f32 (the accumulator), elementwise normalize in the
        # compute dtype: inv is rounded, then two rounded products — the
        # reference's op order, bitwise on CPU
        if not self._native:
            def _f(xf, sf):
                var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
                return xf * torch.rsqrt(var + eps) * sf
            return self.act(_f, x, scale)
        var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
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
