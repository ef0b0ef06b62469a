"""Public entry points of the kernels that draw their own SR bits
(``repro/kernels/ops.py``).

Each op draws u32 bits (as int32) from an explicit ``torch.Generator`` on
the tensors' device (``core.formats.random_bits``), where the reference
draws them from a JAX key; the two give different bits, so the tests hold
the SR ops statistically, and bitwise only when both sides are handed the
same bits. The ops then call the port's kernel wrappers, which launch the
CUDA kernels for CUDA tensors and run their plain versions for CPU tensors.

The update ops return ``(w, m, v, c)`` / ``(w, m, c)`` as the reference's
do (``c`` None without Kahan), but like the port's update kernels they
update w, m, v and c **in place** and return those same tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import random_bits
from repro_torch.kernels.fused_adamw import fused_adamw
from repro_torch.kernels.fused_sgd import fused_sgd
from repro_torch.kernels.qmatmul import qmatmul
from repro_torch.kernels.sr_cast import sr_cast

__all__ = ["sr_cast_op", "qmatmul_op", "adamw_update_op", "sgd_update_op"]


def sr_cast_op(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """SR-cast f32 ``x`` to bf16 with bits drawn from ``generator``."""
    return sr_cast(x, random_bits(x.shape, generator=generator, device=x.device))


def qmatmul_op(x: torch.Tensor, y: torch.Tensor, generator: torch.Generator | None = None,
               *, stochastic: bool = False) -> torch.Tensor:
    """bf16 (M,K) @ (K,N) with f32 accumulation and one rounding: nearest,
    or SR with (M,N) bits drawn from ``generator`` when ``stochastic``."""
    bits = None
    if stochastic:
        if generator is None:
            raise ValueError("stochastic qmatmul_op needs a generator")
        bits = random_bits((x.shape[0], y.shape[1]), generator=generator, device=x.device)
    # The reference sends shapes that are not multiples of 128 to
    # ref.qmatmul_ref (ops.py:35-36), because its Pallas blocks must divide
    # them. The CUDA kernel masks the ragged edge itself, so every shape
    # goes to it and nothing on the card falls back to the plain version.
    return qmatmul(x, y, bits=bits)


def adamw_update_op(w, m, v, g, c, generator: torch.Generator, scalars: dict, *,
                    stochastic: bool = True, kahan: bool = False):
    """One fused AdamW step, in place. ``scalars`` = dict(lr, b1, b2, eps,
    wd, c1, c2); ``c`` (the Kahan buffer) is used only when ``kahan``.
    Returns ``(w, m, v, c)``."""
    bits = random_bits(w.shape, generator=generator, device=w.device)
    return fused_adamw(w, m, v, g, c=c if kahan else None, bits=bits,
                       stochastic=stochastic, **scalars)


def sgd_update_op(w, m, g, c, generator: torch.Generator, scalars: dict, *,
                  stochastic: bool = True, kahan: bool = False):
    """One fused SGD-momentum step, in place. ``scalars`` = dict(lr,
    momentum, wd). Returns ``(w, m, c)``."""
    bits = random_bits(w.shape, generator=generator, device=w.device)
    return fused_sgd(w, m, g, c=c if kahan else None, bits=bits, stochastic=stochastic,
                     lr=scalars["lr"], momentum=scalars["momentum"], wd=scalars["wd"])
