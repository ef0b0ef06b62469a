"""``repro_torch.core.jrandom`` ≡ ``jax.random`` on the CPU, and the
paper's starting draws ≡ the reference's (ROADMAP C19).

* keys, ``split``, ``fold_in``, the 32-bit bits, ``uniform`` and
  ``randint`` bitwise at several shapes and seeds 0–3 (the partitionable
  threefry derivation, jax's default);
* ``normal`` within :data:`NORMAL_ULPS` ulps of ``jax.random.normal`` on
  every element and bitwise on all but :data:`NORMAL_OFF` of them: XLA:CPU's
  f32 ``log1p`` inside ``erf_inv`` is not correctly rounded (ROADMAP C20);
* ``dlrm_init`` against ``repro.models.dlrm.dlrm_init(PRNGKey(s))``,
  ``make_dataset`` against ``repro.models.lstsq.make_dataset``, Fig 2's
  sample indices against the reference's ``randint(fold_in(PRNGKey(1), i))``
  and ``lm_batches`` bitwise against ``repro.data.synthetic.lm_batches``
  (tokens and labels, from ``start_step`` too).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data.synthetic import lm_batches as j_lm_batches
from repro.models.dlrm import DLRM_KAGGLE_SMALL as J_CFG
from repro.models.dlrm import dlrm_init as j_dlrm_init
from repro.models.lstsq import make_dataset as j_make_dataset
from repro_torch.benchmarks.bench_theory import sample_indices
from repro_torch.core import jrandom as J
from repro_torch.data.synthetic import lm_batches
from repro_torch.models.dlrm import DLRM_KAGGLE_SMALL, dlrm_init
from repro_torch.models.lstsq import make_dataset

SEEDS = [0, 1, 2, 3]
SHAPES = [(), (7,), (3, 5), (4, 33, 2)]
# normal's gap to jax.random.normal: at most this many f32 ulps, on at most
# this share of the elements (C20)
NORMAL_ULPS = 3
NORMAL_OFF = 0.02


def _ulps(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _close_normal(got, want, ulps=NORMAL_ULPS, off=NORMAL_OFF):
    d = _ulps(got, want)
    assert d.max(initial=0) <= ulps, d.max()
    assert (d > 0).mean() <= off if d.size >= 100 else True


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_bitwise(seed):
    k, kj = J.PRNGKey(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(k, np.asarray(kj))
    for num in (2, 3, 8):
        np.testing.assert_array_equal(J.split(k, num), np.asarray(jax.random.split(kj, num)))
    for data in (0, 1, 7, 12345, 2 ** 31 - 1):
        np.testing.assert_array_equal(J.fold_in(k, data),
                                      np.asarray(jax.random.fold_in(kj, data)))
    a, b = J.split(J.fold_in(k, 5))
    ja, jb = jax.random.split(jax.random.fold_in(kj, 5))
    np.testing.assert_array_equal(a, np.asarray(ja))
    np.testing.assert_array_equal(b, np.asarray(jb))


def test_threefry2x32_against_the_reference_hash():
    from jax._src import prng as jprng
    key = np.array([0x13198A2E, 0x03707344], np.uint32)
    x = np.arange(64, dtype=np.uint32) * np.uint32(2654435761)
    want = np.asarray(jprng.threefry_2x32(jnp.asarray(key), jnp.asarray(x)))
    b0, b1 = J.threefry2x32(key, x[:32], x[32:])
    np.testing.assert_array_equal(np.concatenate([b0, b1]), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_randint_bitwise(seed, shape):
    k, kj = J.fold_in(J.PRNGKey(seed), 3), jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    np.testing.assert_array_equal(J.bits(k, shape),
                                  np.asarray(jax.random.bits(kj, shape, jnp.uint32)))
    np.testing.assert_array_equal(J.uniform(k, shape), np.asarray(jax.random.uniform(kj, shape)))
    np.testing.assert_array_equal(J.uniform(k, shape, 0.0, 100.0),
                                  np.asarray(jax.random.uniform(kj, shape, minval=0.0,
                                                                maxval=100.0)))
    for lo, hi in ((0, 512), (0, 1000), (-3, 11), (0, 2 ** 31 - 1)):
        np.testing.assert_array_equal(J.randint(k, shape, lo, hi),
                                      np.asarray(jax.random.randint(kj, shape, lo, hi)))


@pytest.mark.parametrize("shape", [(7,), (3, 5), (200, 50), (8, 1000, 16)])
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_the_named_ulps(seed, shape):
    k, kj = J.PRNGKey(seed), jax.random.PRNGKey(seed)
    got = J.normal(k, shape)
    assert got.dtype == np.float32 and got.shape == shape
    _close_normal(got, np.asarray(jax.random.normal(kj, shape)))


@pytest.mark.parametrize("seed", SEEDS)
def test_dlrm_init_is_the_references(seed):
    got = dlrm_init(J.PRNGKey(seed), DLRM_KAGGLE_SMALL, device="cpu")
    want = j_dlrm_init(jax.random.PRNGKey(seed), J_CFG)
    # a normal draw times a scale: one more rounding after normal's ulps
    _close_normal(got["tables"].numpy(), np.asarray(want["tables"]), NORMAL_ULPS + 1)
    for part in ("bottom", "top"):
        assert len(got[part]) == len(want[part])
        for g, w in zip(got[part], want[part]):
            _close_normal(g["kernel"].numpy(), np.asarray(w["kernel"]), NORMAL_ULPS + 1,
                          0.05)
            np.testing.assert_array_equal(g["bias"].numpy(), np.asarray(w["bias"]))


@pytest.mark.parametrize("seed", SEEDS)
def test_make_dataset_is_the_references(seed):
    X, y, w = (t.numpy() for t in make_dataset(J.PRNGKey(seed), n=512, d=10, device="cpu"))
    jX, jy, jw = (np.asarray(a) for a in j_make_dataset(jax.random.PRNGKey(seed), n=512, d=10))
    np.testing.assert_array_equal(w, jw)
    _close_normal(X, jX)
    # y = X·w* + noise: X's ulps times w* up to 100, f32 dots summed in
    # another order
    bound = 2.0 ** -20 * (np.abs(jX) @ np.abs(jw) + 1.0)
    assert (np.abs(y - jy) <= bound).all()


def test_fig2_sample_indices_are_the_references():
    n, steps = 512, 300
    want = jax.vmap(lambda i: jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(1), i),
                                                 (), 0, n))(jnp.arange(steps))
    np.testing.assert_array_equal(sample_indices(steps, n).numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,start", [(0, 0), (1, 0), (4, 3), (3, 7)])
def test_lm_batches_are_the_references(seed, start):
    vocab, batch, seq = 512, 3, 16
    got = lm_batches(vocab, batch, seq, seed=seed, start_step=start, device="cpu")
    want = j_lm_batches(vocab, batch, seq, seed=seed, start_step=start)
    for _ in range(3):
        g, w = next(got), next(want)
        np.testing.assert_array_equal(g["tokens"].numpy(), np.asarray(w["tokens"]))
        np.testing.assert_array_equal(g["labels"].numpy(), np.asarray(w["labels"]))
