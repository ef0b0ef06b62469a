"""Port ≡ reference for the numeric core: formats, policies, FMAC arithmetic.

The same numpy inputs go through ``repro.core`` (JAX on the CPU, eager)
and ``repro_torch.core``. Tolerances:

* ``round_nearest``, ``QArith.einsum``/``dense`` (with bias) and
  ``QArith.rmsnorm``: bitwise — both sides contract bf16 inputs upcast to
  f32 on the CPU and round once with RNE.
* ``silu``, ``gelu`` and ``rope``: within 1 bf16 ulp — JAX's and torch's
  f32 ``exp``/``cos``/``tanh`` differ in the last f32 ulp for some inputs,
  which can flip the final bf16 rounding. Where the op cancels (gelu's
  ``1 + tanh`` near −1, rope's ``x1·cos − x2·sin``) that f32 ulp is
  measured against the operands, so the ulp is taken at the larger of the
  result and ``scale`` (the operand magnitude, times 2^-8 for gelu).
* ``rmsnorm`` under ``fp32``: 1e-6 relative — the f32 mean of f32 squares
  is summed in a different order (bf16 inputs square and sum exactly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import formats as JF
from repro.core import policy as JP
from repro.core.qarith import QArith as JQArith
from repro.models import layers as JL
from repro_torch.core import formats as TF
from repro_torch.core import policy as TP
from repro_torch.core.qarith import QArith as TQArith
from repro_torch.models import layers as TL

# f32-representable bounds: 3e38 itself is not an f32, and hypothesis
# rejects it for width=32
F32_BOUND = 3.0000000054977558e+38
N = 64

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
           jnp.float16: torch.float16}


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _t(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


def assert_within_one_bf16_ulp(got, want, scale=0.0):
    """|got − want| ≤ one bf16 ulp at max(|want|, scale)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.maximum(np.abs(want), scale), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), f"{int(bad.sum())} elements differ by > 1 bf16 ulp"


# ---------------------------------------------------------------------------
# formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(JF.FORMATS))
class TestRoundNearest:
    # f32 subnormals excluded: XLA:CPU flushes them (FTZ/DAZ), torch keeps them
    @settings(max_examples=25, deadline=None)
    @given(st.lists(st.floats(-F32_BOUND, F32_BOUND, width=32, allow_subnormal=False),
                    min_size=N, max_size=N))
    def test_bitwise_against_reference(self, name, xs):
        x = np.asarray(xs, np.float32)
        want = JF.round_nearest(jnp.asarray(x), JF.FORMATS[name])
        got = TF.round_nearest(_t(x), TF.FORMATS[name])
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))

    def test_special_values(self, name):
        fmt = JF.FORMATS[name]
        x = np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                        fmt.max_finite, -fmt.max_finite, 3.4e38, fmt.min_normal,
                        fmt.sub_spacing, 1.0 + 2.0 ** -(fmt.man_bits + 1),
                        1.0 + 3 * 2.0 ** -(fmt.man_bits + 1)] * 4, np.float32)
        want = np.asarray(JF.round_nearest(jnp.asarray(x), fmt))
        got = TF.round_nearest(_t(x), TF.FORMATS[name]).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_array_equal(_bits(got)[ok], _bits(want)[ok])


def test_format_table_matches():
    assert sorted(TF.FORMATS) == sorted(JF.FORMATS)
    for name, f in JF.FORMATS.items():
        g = TF.FORMATS[name]
        assert (g.exp_bits, g.man_bits, g.max_finite, g.min_normal, g.sub_spacing) \
            == (f.exp_bits, f.man_bits, f.max_finite, f.min_normal, f.sub_spacing)


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

def test_presets_equal():
    assert list(TP.PRESETS) == list(JP.PRESETS)
    for name, jp in JP.PRESETS.items():
        tp = TP.PRESETS[name]
        for field in ("param_format", "state_format", "compute_format"):
            assert getattr(tp, field).name == getattr(jp, field).name, (name, field)
        assert (tp.name, tp.update_rounding, tp.kahan, tp.master_weights, tp.native) \
            == (jp.name, jp.update_rounding, jp.kahan, jp.master_weights, jp.native)
        for prop in ("param_dtype", "compute_dtype", "state_dtype"):
            assert getattr(tp, prop) == _DTYPES[getattr(jp, prop)], (name, prop)


# ---------------------------------------------------------------------------
# FMAC arithmetic
# ---------------------------------------------------------------------------

def _qa(name):
    return JQArith(JP.get_policy(name)), TQArith(TP.get_policy(name))


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("policy", ["bf16_standard", "fp32", "bf14_sr"])
def test_dense_with_bias_bitwise(policy):
    jqa, tqa = _qa(policy)
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, (4, 1, 128)), _rand(rng, (128, 256), 0.09), _rand(rng, (256,))
    jx, jw, jb = (jqa.cast(jnp.asarray(a)) for a in (x, w, b))
    tx, tw, tb = (tqa.cast(_t(a)) for a in (x, w, b))
    want = JL.dense(jqa, {"kernel": jw, "bias": jb}, jx)
    got = TL.dense(tqa, {"kernel": tw, "bias": tb}, tx)
    np.testing.assert_array_equal(_bits(got.float().numpy()), _bits(jnp.float32(want)))
    want = jqa.einsum("bsd,df->bsf", jx, jw)
    got = tqa.einsum("bsd,df->bsf", tx, tw)
    np.testing.assert_array_equal(_bits(got.float().numpy()), _bits(jnp.float32(want)))


@pytest.mark.parametrize("policy", ["bf16_standard", "fp32", "bf14_sr"])
def test_rmsnorm(policy):
    jqa, tqa = _qa(policy)
    rng = np.random.default_rng(1)
    x, s = _rand(rng, (8, 1, 128), 3.0), 1.0 + _rand(rng, (128,), 0.1)
    want = jnp.float32(jqa.rmsnorm(jqa.cast(jnp.asarray(x)), jnp.asarray(s)))
    got = tqa.rmsnorm(tqa.cast(_t(x)), _t(s)).float().numpy()
    if policy == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activation_within_one_bf16_ulp(act):
    jqa, tqa = _qa("bf16_standard")
    x = _rand(np.random.default_rng(2), (4096,), 4.0)
    want = getattr(jqa, act)(jqa.cast(jnp.asarray(x)))
    got = getattr(tqa, act)(tqa.cast(_t(x)))
    assert got.dtype == torch.bfloat16
    scale = np.abs(x) * 2.0 ** -8 if act == "gelu" else 0.0
    assert_within_one_bf16_ulp(got.float().numpy(), jnp.float32(want), scale)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_within_one_bf16_ulp(theta):
    rng = np.random.default_rng(3)
    x = _rand(rng, (4, 1, 16, 128))
    pos = rng.integers(0, 4096, size=(4, 1)).astype(np.int32)
    want = JL.rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), theta)
    got = TL.rope(_t(x, torch.bfloat16), torch.from_numpy(pos), theta)
    assert got.dtype == torch.bfloat16
    xb = np.asarray(jnp.float32(jnp.asarray(x, jnp.bfloat16)))
    pair = np.maximum(np.abs(xb[..., :64]), np.abs(xb[..., 64:]))
    assert_within_one_bf16_ulp(got.float().numpy(), jnp.float32(want),
                               np.concatenate([pair, pair], axis=-1))
