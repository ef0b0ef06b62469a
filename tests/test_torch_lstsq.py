"""The port's least-squares model ≡ the reference, on the CPU.

* ``lstsq_grad_quantized`` on the same ``w, x, y``, for ``fmt`` None,
  BF16 and FP16:
  - on inputs whose f32 dot product is exact in any summation order
    (small integers over a power of two), all three bitwise;
  - on Gaussian inputs at Fig 2's scale the reference's CPU dot (a
    library call) sums the 10 products in its own order, so None holds
    within the f32 accumulation bound ``10 · 2⁻²⁴ · Σ|xᵢwᵢ|`` times |x|;
    under BF16 and FP16 a sample whose rounded activation a = Q(x·w − y)
    is the reference's has a bitwise gradient, and where the dot's last
    ulp moves a across a rounding boundary (under 1% of samples), a lies
    one ulp of the format away.
* ``make_dataset``: a key makes it deterministic; the draws are the
  reference's (tests/test_torch_jrandom.py holds them to it), with its
  distributions: x ~ N(0, 1), w* ∈ [0, 100), residual noise of std 0.5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FORMATS as J_FORMATS
from repro.core.formats import round_nearest as J_round_nearest
from repro.models.lstsq import lstsq_grad_quantized as j_grad
from repro.models.lstsq import make_dataset as j_make_dataset
from repro_torch.core.formats import FORMATS, round_nearest, ulp
from repro_torch.core import jrandom
from repro_torch.models.lstsq import lstsq_grad_quantized, make_dataset
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse fixture)


FMTS = [None, "bf16", "fp16"]
N = 256


def _both(w, x, y, fmt):
    want = np.stack([np.asarray(j_grad(jnp.asarray(w[i]), jnp.asarray(x[i]),
                                       jnp.asarray(y[i]), fmt and J_FORMATS[fmt]))
                     for i in range(len(w))])
    got = np.stack([lstsq_grad_quantized(torch.from_numpy(w[i]), torch.from_numpy(x[i]),
                                         torch.from_numpy(y[i:i + 1])[0],
                                         fmt and FORMATS[fmt]).numpy()
                    for i in range(len(w))])
    return got, want


@pytest.mark.parametrize("fmt", FMTS)
def test_grad_bitwise_where_the_dot_is_exact(fmt):
    rng = np.random.default_rng(1)
    w = (rng.integers(-512, 512, (N, 10)) / 8).astype(np.float32)
    x = (rng.integers(-64, 64, (N, 10)) / 4).astype(np.float32)
    y = (rng.integers(-4096, 4096, N) / 2).astype(np.float32)
    got, want = _both(w, x, y, fmt)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", FMTS)
def test_grad_on_gaussian_inputs(fmt):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((N, 10)).astype(np.float32)
    w = (rng.random((N, 10)) * 100).astype(np.float32)
    y = (x @ w.mean(0) + rng.standard_normal(N)).astype(np.float32)
    got, want = _both(w, x, y, fmt)
    if fmt is None:
        bound = 10 * 2.0 ** -24 * np.abs(x * w).sum(1, keepdims=True) * np.abs(x)
        assert (np.abs(got - want) <= bound).all()
        return
    f = FORMATS[fmt]
    ja, ta = (np.stack([v(i) for i in range(N)]) for v in (
        lambda i: np.asarray(J_round_nearest(jnp.asarray(x[i]) @ jnp.asarray(w[i])
                                             - jnp.asarray(y[i]), J_FORMATS[fmt])),
        lambda i: float(round_nearest(torch.from_numpy(x[i]) @ torch.from_numpy(w[i])
                                      - torch.from_numpy(y[i:i + 1])[0], f))))
    same = ja == ta
    np.testing.assert_array_equal(got[same], want[same])
    assert (~same).mean() < 0.01
    assert (np.abs(ja - ta)[~same] <= ulp(torch.from_numpy(ta[~same]), f).numpy()).all()


def test_make_dataset_deterministic_with_the_reference_distributions():
    X, y, w_star = make_dataset(jrandom.PRNGKey(0), n=4096, d=10, device="cpu")
    again = make_dataset(jrandom.PRNGKey(0), n=4096, d=10, device="cpu")
    other = make_dataset(jrandom.PRNGKey(1), n=4096, d=10, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip((X, y, w_star), again))
    assert not torch.equal(X, other[0])
    jX, jy, jw = j_make_dataset(jax.random.PRNGKey(0), n=4096, d=10)
    for a, b in zip((X, y, w_star), (jX, jy, jw)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
    assert abs(float(X.mean())) < 0.02 and abs(float(X.std()) - 1.0) < 0.02
    assert float(w_star.min()) >= 0.0 and float(w_star.max()) < 100.0
    noise = (y - X @ w_star).double()
    assert abs(float(noise.std()) - 0.5) < 0.02
