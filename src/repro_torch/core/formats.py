"""Floating-point formats and nearest rounding (port of ``repro.core.formats``).

The paper's FMAC unit: 16-bit inputs, 32-bit accumulation, one rounding of
the output. ``bf16``/``fp16``/``fp32`` round through the native torch
casts (round-to-nearest-even in both frameworks); the simulated grids
(bf14/bf12/bf10 and the fp8 wire formats e5m2/e4m3) are carried in f32
snapped onto the format's grid with the same bit tricks as the reference.

Stochastic rounding arrives with the training slice.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["FloatFormat", "BF16", "BF14", "BF12", "BF10", "FP16", "FP32",
           "E5M2", "E4M3", "FORMATS", "round_nearest"]


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """An IEEE-like binary float format with f32-compatible exponent layout."""

    name: str
    exp_bits: int
    man_bits: int

    @property
    def shift(self) -> int:
        # number of low mantissa bits of f32 dropped by this format
        return 23 - self.man_bits

    @property
    def machine_eps(self) -> float:
        return 2.0 ** (-self.man_bits - 1)

    @property
    def bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    @property
    def is_f32_exponent(self) -> bool:
        return self.exp_bits == 8

    @property
    def emax(self) -> int:
        return 2 ** (self.exp_bits - 1) - 1

    @property
    def max_finite(self) -> float:
        man = (2 ** self.man_bits - 1) / 2 ** self.man_bits
        return float((1.0 + man) * 2.0 ** self.emax)

    @property
    def min_normal(self) -> float:
        return float(2.0 ** (1 - self.emax))

    @property
    def sub_spacing(self) -> float:
        return float(self.min_normal * 2.0 ** (-self.man_bits))


BF16 = FloatFormat("bf16", 8, 7)
BF14 = FloatFormat("bf14", 8, 5)
BF12 = FloatFormat("bf12", 8, 3)
BF10 = FloatFormat("bf10", 8, 1)
FP16 = FloatFormat("fp16", 5, 10)
FP32 = FloatFormat("fp32", 8, 23)
E5M2 = FloatFormat("e5m2", 5, 2)
E4M3 = FloatFormat("e4m3", 4, 3)

FORMATS = {f.name: f for f in (BF16, BF14, BF12, BF10, FP16, FP32, E5M2, E4M3)}

_U32 = 0xFFFFFFFF


def _round_nearest_e8(x: torch.Tensor, shift: int) -> torch.Tensor:
    """RNE truncation of the f32 mantissa: add ``half - 1 + lsb`` to the raw
    bits, then clear the low ``shift`` bits (round-half-to-even).

    The u32 arithmetic of the reference runs in int64 here (torch has no
    u32 add on every backend); the result is masked back to 32 bits and
    reinterpreted as a signed i32 before the bitcast to f32."""
    b = x.view(torch.int32).to(torch.int64) & _U32
    lsb = (b >> shift) & 1
    rounded = (b + (2 ** (shift - 1) - 1) + lsb) & (_U32 & ~(2 ** shift - 1))
    rounded = torch.where(rounded >= 2 ** 31, rounded - 2 ** 32, rounded)
    out = rounded.to(torch.int32).view(torch.float32)
    # preserve NaN (the bias-add could overflow a NaN mantissa into inf)
    return torch.where(torch.isnan(x), x, out)


def _round_nearest_small_exp(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """RNE for ``exp_bits < 8`` formats: the e8 trick on normals, the fixed
    ``sub_spacing`` lattice (half-to-even) below ``min_normal``, and
    saturation at ``max_finite`` (these grids carry no ±inf)."""
    mx, mn, sp = fmt.max_finite, fmt.min_normal, fmt.sub_spacing
    clamped = torch.clamp(x, -mx, mx)           # maps ±inf to ±max_finite too
    normal = _round_nearest_e8(clamped, fmt.shift)
    sub = torch.round(clamped / sp) * sp
    out = torch.where(torch.abs(clamped) < mn, sub, normal)
    # the RNE trick can round the top half-ulp past max_finite
    out = torch.clamp(out, -mx, mx)
    return torch.where(torch.isnan(x), x, out)


def round_nearest(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """Round-to-nearest-even onto ``fmt``'s grid; result carried in f32."""
    x = x.to(torch.float32)
    if fmt.name == "fp32":
        return x
    if fmt.name == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if fmt.name == "fp16":
        return x.to(torch.float16).to(torch.float32)
    if fmt.is_f32_exponent:
        return _round_nearest_e8(x.contiguous(), fmt.shift)
    return _round_nearest_small_exp(x.contiguous(), fmt)
