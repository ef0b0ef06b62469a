"""The port's ``qmatmul`` (its plain version on the CPU) against the
reference's Pallas ``qmatmul`` in interpret mode and ``ref.qmatmul_ref``.

The same numpy inputs (bf16 x, y and u32 bits, from a seed) go to every
side. All of them accumulate in f32 but sum the K products in different
orders (the Pallas kernel by 128-deep tiles, XLA's and torch's CPU dots
by their own blocking), so an f32-ulp difference in the accumulator can
flip the bf16 rounding — or, under SR with the same bits, a carry. The
criterion is that of ``tests/test_kernels.py::assert_bf16_close``: at
most 1 bf16 ulp, on at most 0.5% of the outputs; the rest bit for bit.
Its ``atol`` is ``e = K·2⁻²³·(|x|@|y|)``, the bound on how far two f32
accumulations of the same products can part: where the sum cancels, an
output far below its terms carries an f32 error of the terms' scale, more
than one ulp of the output (as the m slot of ``test_fused_adamw_sweep``
takes an atol from its addends). Every output is also held to the exact
(f64) product of the same bf16 inputs:
``|out − exact| ≤ ulp_bf16(|exact| + e) + e``.

Where every accumulator is exact in any order (one or two nonzero
products per output), kernel and references must agree bit for bit:
±inf, NaN, inf − inf, overflow past f32 max, and SR carrying the largest
bf16 value into inf with bits 0xFFFF.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as JREF
from repro.kernels.qmatmul import qmatmul as pallas_qmatmul
from repro_torch.kernels.qmatmul import qmatmul, qmatmul_ref

QM = importlib.import_module("repro_torch.kernels.qmatmul")

SWEEP = [(128, 128, 128), (256, 128, 512), (384, 256, 640)]      # (M, N, K), test_kernels.py
RAGGED = [(129, 77, 200), (129, 200, 77), (1, 5, 3), (8, 256, 72), (33, 1, 130)]
MAX_FRAC = 0.005
BF16_MAX = float(jnp.finfo(jnp.bfloat16).max)


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy bf16 or u32 → torch bf16 or int32, bits moved unchanged."""
    a = np.ascontiguousarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    return torch.from_numpy(a.copy())


def _inputs(M: int, N: int, K: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32).astype(jnp.bfloat16)
    y = rng.standard_normal((K, N)).astype(np.float32).astype(jnp.bfloat16)
    bits = rng.integers(0, 2**32, size=(M, N), dtype=np.uint32)
    return x, y, bits


def accumulation_bound(x, y) -> np.ndarray:
    """``K·2⁻²³·(|x|@|y|)``: how far an f32 accumulation of the products of
    bf16 ``x`` and ``y`` may lie from the exact sum, and so from another."""
    xd, yd = np.asarray(x).astype(np.float64), np.asarray(y).astype(np.float64)
    return xd.shape[1] * 2.0 ** -23 * (np.abs(xd) @ np.abs(yd))


def assert_bf16_close(got: torch.Tensor, want, max_frac: float = MAX_FRAC, atol=0.0):
    """≤ 1 bf16 ulp (2⁻⁷ of the magnitude) plus ``atol`` on at most
    ``max_frac`` of the outputs, the rest equal (NaN lanes NaN on both
    sides)."""
    g = got.float().numpy()
    w = np.asarray(want).astype(np.float32)
    nan = np.isnan(w)
    np.testing.assert_array_equal(np.isnan(g), nan, err_msg="NaN lanes")
    neq = (g != w) & ~nan
    assert neq.mean() <= max_frac, f"{neq.mean():.4%} of outputs differ"
    tol = 2.0 ** -7 * np.maximum(np.abs(w), 2.0 ** -126) + atol
    assert np.all(np.abs(g[neq] - w[neq]) <= tol[neq]), "an output differs by more than 1 ulp"
    return float(neq.mean())


def assert_within_exact(got: torch.Tensor, x, y):
    """Within one bf16 ulp plus the f32 accumulation bound of the exact
    product of the bf16 inputs."""
    exact = np.asarray(x).astype(np.float64) @ np.asarray(y).astype(np.float64)
    e = accumulation_bound(x, y)
    mag = np.maximum(np.abs(exact) + e, 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    err = np.abs(got.double().numpy() - exact)
    assert np.all(err <= ulp + e), f"max excess {np.max(err - ulp - e)}"


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("mnk", SWEEP)
def test_plain_matches_pallas_interpret_and_ref(mnk, stochastic):
    M, N, K = mnk
    x, y, bits = _inputs(M, N, K, M + N + K)
    bits = bits if stochastic else None
    jbits = None if bits is None else jnp.asarray(bits)
    pallas = pallas_qmatmul(jnp.asarray(x), jnp.asarray(y), bits=jbits, bm=128, bn=128,
                            bk=128, interpret=True)
    want = JREF.qmatmul_ref(jnp.asarray(x), jnp.asarray(y), bits=jbits)
    tbits = None if bits is None else _t(bits)
    got = qmatmul(_t(x), _t(y), bits=tbits)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert torch.equal(got.view(torch.int16),
                       qmatmul_ref(_t(x), _t(y), bits=tbits).view(torch.int16))
    e = accumulation_bound(x, y)
    assert_bf16_close(got, pallas, atol=e)
    assert_bf16_close(got, want, atol=e)
    assert_within_exact(got, x, y)


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("mnk", RAGGED)
def test_plain_matches_ref_on_ragged_shapes(mnk, stochastic):
    """Shapes the Pallas kernel's blocks cannot take (the reference's op
    sends them to ``ref.qmatmul_ref``)."""
    M, N, K = mnk
    x, y, bits = _inputs(M, N, K, 7 * M + N + K)
    bits = bits if stochastic else None
    want = JREF.qmatmul_ref(jnp.asarray(x), jnp.asarray(y),
                            bits=None if bits is None else jnp.asarray(bits))
    got = qmatmul(_t(x), _t(y), bits=None if bits is None else _t(bits))
    assert got.shape == (M, N)
    assert_bf16_close(got, want, atol=accumulation_bound(x, y))
    assert_within_exact(got, x, y)


def test_k_accumulation_in_f32():
    """Port of tests/test_kernels.py::test_qmatmul_k_accumulation_in_f32:
    1024 products of 0.01² are not lost to a bf16 accumulator (the
    32-bit-accumulator property of the paper's Table 1)."""
    K = 1024
    x = torch.full((128, K), 0.01, dtype=torch.bfloat16)
    y = torch.full((K, 128), 0.01, dtype=torch.bfloat16)
    out = qmatmul(x, y).float()
    expect = K * float(torch.tensor(0.01, dtype=torch.bfloat16)) ** 2
    assert abs(float(out[0, 0]) / expect - 1) < 0.01
    assert bool((out == out[0, 0]).all())


def edge_inputs():
    """x rows whose dot with a column of ones is exact in any order:
    ±inf, NaN, inf − inf, bf16 max ± 2¹¹⁰ (SR with 0xFFFF carries into
    inf), 2·bf16 max (overflows f32), a finite sum. K = 8, N = 16."""
    rows = [[np.inf], [-np.inf], [np.nan], [np.inf, -np.inf], [BF16_MAX, 2.0 ** 110],
            [-BF16_MAX, -2.0 ** 110], [BF16_MAX, BF16_MAX], [BF16_MAX], [1.0, 2.0 ** -9],
            [0.0]]
    x = np.zeros((len(rows), 8), np.float32)
    for i, r in enumerate(rows):
        x[i, :len(r)] = r
    y = np.ones((8, 16), np.float32)
    return x.astype(jnp.bfloat16), y.astype(jnp.bfloat16)


@pytest.mark.parametrize("bits_value", [None, 0, 0xFFFF, 0x8000])
def test_nonfinite_and_near_max_lanes_bitwise(bits_value):
    x, y = edge_inputs()
    bits = None if bits_value is None else np.full((x.shape[0], y.shape[1]), bits_value,
                                                   np.uint32)
    want = np.asarray(JREF.qmatmul_ref(jnp.asarray(x), jnp.asarray(y),
                                       bits=None if bits is None else jnp.asarray(bits)))
    got = qmatmul(_t(x), _t(y), bits=None if bits is None else _t(bits))
    assert_bf16_close(got, want, max_frac=0.0)
    g = got.float().numpy()
    assert np.isinf(g[6]).all() and (g[6] > 0).all()          # 2·max overflows f32
    if bits_value == 0xFFFF:
        assert np.isposinf(g[4]).all() and np.isneginf(g[5]).all()
    else:
        assert (g[4] == BF16_MAX).all() and (g[5] == -BF16_MAX).all()


def test_wrapper_raises_on_what_it_cannot_take():
    x = torch.zeros((4, 8), dtype=torch.bfloat16)
    y = torch.zeros((8, 3), dtype=torch.bfloat16)
    bits = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="bf16"):
        qmatmul(x.float(), y)
    with pytest.raises(ValueError, match="2-D"):
        qmatmul(x.reshape(-1), y)
    with pytest.raises(ValueError, match="inner dimensions"):
        qmatmul(x, y[:5])
    with pytest.raises(ValueError, match="int32"):
        qmatmul(x, y, bits=bits.long())
    with pytest.raises(ValueError, match="shape"):
        qmatmul(x, y, bits=bits.T.contiguous())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        qmatmul(x.to("meta"), y.to("meta"))
    with pytest.raises(ValueError, match="is on meta"):
        qmatmul(x, y.to("meta"))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    x, y, bits = _inputs(16, 24, 40, 3)
    before = QM.LAUNCHES
    for b in (None, _t(bits)):
        got = qmatmul(_t(x), _t(y), bits=b)
        assert torch.equal(got.view(torch.int16),
                           qmatmul_ref(_t(x), _t(y), bits=b).view(torch.int16))
    assert QM.LAUNCHES == before


# The kernel's path and tiles are a function of N, K and the operands'
# alignment only (``plan`` mirrors ``choose_path`` of csrc/qmatmul.cu; on
# the card tests/test_torch_cuda.py holds the library to it): then row i of
# (M,K) @ (K,N) is the same bits for every M, which chunked prefill needs
# (ROADMAP C10).
_BUF = torch.empty(4096 * 96 + 16, dtype=torch.bfloat16)
_BITS = torch.empty(4096 * 96 + 8, dtype=torch.int32)


@settings(max_examples=80, deadline=None)
@given(N=st.integers(1, 96), K=st.integers(0, 96),
       Ms=st.lists(st.integers(1, 4096), min_size=2, max_size=4),
       x_off=st.integers(0, 8), y_off=st.integers(0, 8), bits_off=st.integers(0, 4),
       sr=st.booleans())
def test_plan_does_not_depend_on_the_row_count(N, K, Ms, x_off, y_off, bits_off, sr):
    assert _BUF.data_ptr() % 16 == 0 and _BITS.data_ptr() % 16 == 0
    y = _BUF[y_off:y_off + K * N].view(K, N)
    plans = set()
    for M in Ms:
        x = _BUF[x_off:x_off + M * K].view(M, K)
        bits = _BITS[bits_off:bits_off + M * N].view(M, N) if sr else None
        plans.add(QM.plan(x, y, bits))
    assert len(plans) == 1
    (got,) = plans
    aligned = x_off % 8 == 0 and y_off % 8 == 0 and (not sr or bits_off % 4 == 0)
    tma = K > 0 and K % 8 == 0 and N % 8 == 0 and aligned
    assert got.path == ("wgmma" if tma else "mma.sync")
    assert got.tile == (128, 128) and got.promote <= 512     # the reference's K tile
