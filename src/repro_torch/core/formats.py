"""Floating-point formats, nearest and stochastic rounding (port of
``repro.core.formats``).

The paper's FMAC unit: 16-bit inputs, 32-bit accumulation, one rounding of
the output. ``bf16``/``fp16``/``fp32`` round to nearest through the
native torch casts (round-to-nearest-even in both frameworks); the
simulated grids (bf14/bf12/bf10 and the fp8 wire formats e5m2/e4m3) are
carried in f32 snapped onto the format's grid with the same bit tricks as
the reference.

Stochastic rounding takes its randomness explicitly: ``noise`` (u32 bits
carried in an int32 or int64 tensor; the low ``shift`` bits are used) and,
for the fp16 and small-exponent branches, ``u`` (f32 uniforms in [0, 1)),
or a ``torch.Generator`` to draw them from. Fed the reference's bits, every
branch is bitwise equal to it. Bits drawn here come from
``Tensor.random_`` on int32, which fills 31 bits: enough, since no format
drops more than 22.

The bit-level quantizers have zero gradient, so simulated-format training
uses straight-through (identity) gradients, as the reference's
``custom_jvp`` wrappers do: every quantizer here is a
``torch.autograd.Function`` whose backward passes the gradient through.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["FloatFormat", "BF16", "BF14", "BF12", "BF10", "FP16", "FP32",
           "E5M2", "E4M3", "FORMATS", "round_nearest", "round_stochastic",
           "stochastic_round_bf16", "random_bits", "nearest_representable",
           "ulp", "sqrt_rn", "clamp_finite", "wire_carrier_dtype"]


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


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The raw u32 bits of an f32 tensor, carried in int64 (torch has no
    u32 arithmetic on every backend)."""
    return x.contiguous().view(torch.int32).to(torch.int64) & _U32


def _from_bits(b: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 bits → f32 (masked to 32 bits, reinterpreted)."""
    b = b & _U32
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b)
    return b.to(torch.int32).view(torch.float32)


# ---------------------------------------------------------------------------
# Nearest rounding (RNE)
# ---------------------------------------------------------------------------

def _round_nearest_e8(x: torch.Tensor, shift: int) -> torch.Tensor:
    """RNE truncation of the f32 mantissa: add ``half - 1 + lsb`` to the raw
    bits, then clear the low ``shift`` bits (round-half-to-even)."""
    b = _bits(x)
    lsb = (b >> shift) & 1
    out = _from_bits((b + (2 ** (shift - 1) - 1) + lsb) & ~(2 ** shift - 1))
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


class _NearestE8(torch.autograd.Function):
    """``_ste_nearest`` (reference ``formats.py:137``): RNE onto an e8 grid,
    identity gradient."""

    @staticmethod
    def forward(ctx, x, shift):
        return _round_nearest_e8(x, shift)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _NearestSmallExp(torch.autograd.Function):
    """``_ste_nearest_small_exp`` (reference ``formats.py:160``)."""

    @staticmethod
    def forward(ctx, x, fmt):
        return _round_nearest_small_exp(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return g, None


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
        return _NearestE8.apply(x.contiguous(), fmt.shift)
    return _NearestSmallExp.apply(x.contiguous(), fmt)


# ---------------------------------------------------------------------------
# Stochastic rounding
# ---------------------------------------------------------------------------

def random_bits(shape, *, generator: torch.Generator, device=None) -> torch.Tensor:
    """u32 SR bits as int32, drawn from ``generator``. ``random_`` on int32
    fills the low 31 bits; SR uses at most the low 22."""
    device = generator.device if device is None else device
    return torch.empty(shape, dtype=torch.int32, device=device).random_(
        generator=generator)


def _sr_e8(x: torch.Tensor, noise: torch.Tensor, shift: int) -> torch.Tensor:
    """Add the (masked) noise to the raw bits, truncate the low ``shift``
    bits; non-finite inputs pass through (``_ste_stochastic``)."""
    out = _from_bits((_bits(x) + noise) & ~(2 ** shift - 1))
    return torch.where(torch.isfinite(x), out, x)


def _sr_fp16(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """SR onto the float16 grid through explicit neighbours (the reference's
    ``_round_stochastic_fp16``, ``formats.py:246``): e5 range and
    subnormals exact, P[up] = (x − lo)/(hi − lo)."""
    near = x.to(torch.float16)
    near_f32 = near.to(torch.float32)
    nb16 = near.view(torch.int16).to(torch.int32) & 0xFFFF
    is_pos_step = near_f32 < x                     # the upper neighbour is needed
    sign = nb16 & 0x8000
    mag = nb16 & 0x7FFF
    toward_inf = torch.where(sign == 0, is_pos_step, ~is_pos_step)
    mag_next = torch.where(toward_inf, mag + 1, torch.clamp(mag, min=1) - 1)
    # crossing zero: stepping "down" from ±0 flips to the smallest subnormal
    crosses = (mag == 0) & ~toward_inf
    sign_next = torch.where(crosses, sign ^ 0x8000, sign)
    mag_next = torch.where(crosses, 1, mag_next)
    other16 = sign_next | mag_next
    other16 = torch.where(other16 >= 0x8000, other16 - 0x10000, other16)
    other = other16.to(torch.int16).view(torch.float16).to(torch.float32)
    lo = torch.minimum(near_f32, other)
    hi = torch.maximum(near_f32, other)
    denom = hi - lo
    pos = denom > 0
    p_up = torch.where(pos, (x - lo) / torch.where(pos, denom, 1.0), 0.0)
    y = torch.where(u < p_up, hi, lo)
    y = torch.where(near_f32 == x, near_f32, y)
    return torch.where(torch.isfinite(x), y, x)


def _sr_small_exp(x: torch.Tensor, noise: torch.Tensor, u: torch.Tensor,
                  fmt: FloatFormat) -> torch.Tensor:
    """SR for ``exp_bits < 8`` formats (``formats.py:278``): the e8 bit trick
    on the input clamped to ±max_finite, floor + Bernoulli on the
    ``sub_spacing`` lattice below ``min_normal``, saturation at max."""
    mx, mn, sp = fmt.max_finite, fmt.min_normal, fmt.sub_spacing
    clamped = torch.clamp(x, -mx, mx)
    normal = _from_bits((_bits(clamped) + noise) & ~(2 ** fmt.shift - 1))
    t = clamped / sp
    lo = torch.floor(t)
    sub = (lo + (u < (t - lo)).to(torch.float32)) * sp
    out = torch.where(torch.abs(clamped) < mn, sub, normal)
    # x in the top binade can SR up one grid step past max_finite
    out = torch.clamp(out, -mx, mx)
    return torch.where(torch.isnan(x), x, out)


class _Stochastic(torch.autograd.Function):
    """Every SR branch behind one straight-through gradient (the reference's
    ``_ste_stochastic`` and ``_ste_stochastic_small_exp``; its fp16 branch
    is built from selects, and the port passes the gradient through there
    too)."""

    @staticmethod
    def forward(ctx, x, noise, u, fmt):
        if fmt.name == "fp16":
            return _sr_fp16(x, u)
        if fmt.is_f32_exponent:
            return _sr_e8(x, noise, fmt.shift)
        return _sr_small_exp(x, noise, u, fmt)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def round_stochastic(x: torch.Tensor, fmt: FloatFormat, *, noise=None, u=None,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """Stochastically round onto ``fmt``'s grid; result carried in f32.

    ``noise``: u32 bits (int32 or int64 tensor, x's shape) for the e8 and
    small-exponent branches; ``u``: f32 uniforms for the fp16 and
    small-exponent branches. What is not given is drawn from
    ``generator``."""
    x = x.to(torch.float32).contiguous()
    if fmt.name == "fp32":
        return x

    def need(what):
        if generator is None:
            raise ValueError(f"round_stochastic onto {fmt.name} needs {what}= "
                             "or generator=")

    if fmt.name != "fp16":
        if noise is None:
            need("noise")
            noise = random_bits(x.shape, generator=generator, device=x.device)
        noise = noise.to(torch.int64) & (2 ** fmt.shift - 1)
    if fmt.name == "fp16" or not fmt.is_f32_exponent:
        if u is None:
            need("u")
            u = torch.rand(x.shape, generator=generator, device=x.device)
        u = u.to(torch.float32)
    return _Stochastic.apply(x, noise, u, fmt)


def stochastic_round_bf16(x: torch.Tensor, *, noise=None,
                          generator: torch.Generator | None = None) -> torch.Tensor:
    """f32 → native bfloat16 with stochastic rounding."""
    return round_stochastic(x, BF16, noise=noise, generator=generator).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Utilities
# ---------------------------------------------------------------------------

def ulp(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """Distance to the next-larger representable magnitude in ``fmt``
    (the reference's bit-level construction, exact down to subnormals)."""
    x = torch.abs(round_nearest(x, fmt)).contiguous()
    if not fmt.is_f32_exponent:
        e_field = torch.clamp((_bits(x) >> 23) & 0xFF, min=fmt.man_bits + 1)
        normal = _from_bits((e_field - fmt.man_bits) << 23)
        return torch.where(x < fmt.min_normal,
                           torch.tensor(fmt.sub_spacing, dtype=torch.float32,
                                        device=x.device), normal)
    b = _bits(x)
    step = 2 ** fmt.shift
    diff = _from_bits(b + step) - x
    # spacings below 2^-126 are f32 subnormals: assemble them from bits
    exp = (b >> 23) & 0xFF
    shift_c = torch.clamp(torch.clamp(exp, min=1) - 1, max=23)
    tiny = _from_bits(step << shift_c)
    return torch.where(fmt.shift + shift_c < 23, tiny, diff)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """f32 square root rounded once to nearest (IEEE ``sqrt``), as XLA's and
    CUDA's ``sqrtf`` give it. torch's CPU kernel is off by an ulp on ~1% of
    inputs, so on the CPU the root is taken in f64 and rounded to f32 —
    exact, since f64 carries more than twice f32's precision."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def clamp_finite(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """Saturate ``x`` to ``[-max_finite, max_finite]`` (±inf included; NaN
    propagates)."""
    return torch.clamp(x.to(torch.float32), -fmt.max_finite, fmt.max_finite)


def wire_carrier_dtype(fmt: FloatFormat) -> torch.dtype:
    """The native dtype whose grid holds every value of ``fmt``: what a
    gradient wire at ``fmt`` carries. The e8 sub-16-bit formats
    (bf14/bf12/bf10) are subsets of bfloat16's grid; fp16, e5m2 and e4m3
    (their subnormals included) of float16's. The accounted wire width is
    ``fmt.bits``, not the carrier's."""
    if fmt.name == "fp32":
        return torch.float32
    if fmt.is_f32_exponent:
        return torch.bfloat16
    return torch.float16


def nearest_representable(value: float, fmt: FloatFormat = BF16, *,
                          below_one: bool = False) -> float:
    """Nearest value on ``fmt``'s grid; optionally the largest one < 1
    (the paper's β₂ clamp: 0.999 rounds to 1.0 in bf16)."""
    v = float(round_nearest(torch.tensor(value, dtype=torch.float32), fmt))
    if below_one and v >= 1.0:
        one = _bits(torch.tensor(1.0, dtype=torch.float32))
        v = float(_from_bits(one - 2 ** fmt.shift))
    return v
