"""The port's kernel op layer (``repro_torch.kernels.ops``) against the
reference's (``repro.kernels.ops``) and ``repro/kernels/ref.py``.

The port's ops draw their SR bits from a ``torch.Generator``, the
reference's from a JAX key, so the two are held:

- bitwise where the bits do not matter (nearest) or where both sides get
  the same bits: the port's op against the eager ``ref.py`` fed the bits
  the same generator seed draws (``core.formats.random_bits``);
- against the reference's jitted ops, whose jitted bodies XLA:CPU
  contracts into FMAs on a few lanes (ROADMAP C8): bitwise off those lanes
  (where the jitted op departs from the eager ``ref.py``), at most
  ``FMA_TIE_FRAC`` of them, as ``tests/test_torch_update_kernels.py`` does;
- ``qmatmul_op`` within the criterion of ``tests/test_torch_qmatmul.py``
  (f32 sums in different orders);
- statistically: the mean over draws of an SR output lands within 5σ of
  the f32 accumulator it rounds (the binomial bound of
  ``tests/test_formats_properties.py``), and within 5σ plus the f32
  accumulation bound of the exact product;
- deterministically: a re-seeded generator gives the same outputs.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as JK
import repro_torch.kernels as TK
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro_torch.core.formats import random_bits
from repro_torch.kernels import ops
from repro_torch.kernels.fused_adamw import fused_adamw
from repro_torch.kernels.fused_sgd import fused_sgd
from repro_torch.kernels.qmatmul import qmatmul

QM = importlib.import_module("repro_torch.kernels.qmatmul")

F32 = np.float32
ADAMW_HP = dict(lr=F32(1e-3), b1=F32(0.8984375), b2=F32(0.99609375), eps=F32(1e-8),
                wd=F32(0.01), c1=F32(0.9), c2=F32(0.99609375))
SGD_HP = dict(lr=F32(0.1), momentum=F32(0.9), wd=F32(1e-4))
VARIANTS = [(False, False), (True, False), (False, True), (True, True)]
FMA_TIE_FRAC = 5e-4
FIVE_SIGMA = 5.0
BF16_MAX = float(jnp.finfo(jnp.bfloat16).max)


def _t(a) -> torch.Tensor:
    """numpy (bf16, f32 or u32) → torch, bits moved unchanged."""
    a = np.ascontiguousarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    return torch.from_numpy(a.copy())


def _u32(bits: torch.Tensor) -> np.ndarray:
    return bits.numpy().view(np.uint32)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _same(got: torch.Tensor, want, what: str, where=None):
    """Bitwise equal bf16 (on ``where`` if given), NaN lanes NaN on both sides."""
    want = np.asarray(want)
    g_bits, w_bits = got.contiguous().view(torch.int16).numpy(), want.view(np.int16)
    g_nan, w_nan = torch.isnan(got.float()).numpy(), np.isnan(want.astype(np.float32))
    where = np.ones(want.shape, bool) if where is None else where
    np.testing.assert_array_equal(g_nan[where], w_nan[where], err_msg=f"{what}: NaN lanes")
    bad = (g_bits != w_bits) & ~w_nan & where
    assert not bad.any(), f"{what}: {int(bad.sum())} of {bad.size} differ"


def _same_off_fma_ties(got: torch.Tensor, jitted, eager, what: str):
    """Bitwise equal to the jitted reference op except on the lanes where it
    departs from the eager ``ref.py`` (FMA contraction, ROADMAP C8)."""
    jitted, eager = np.asarray(jitted), np.asarray(eager)
    ties = (jitted.view(np.int16) != eager.view(np.int16)) & ~np.isnan(eager.astype(np.float32))
    assert ties.mean() <= FMA_TIE_FRAC, f"{what}: {int(ties.sum())} FMA-tie lanes"
    _same(got, jitted, what, where=~ties)


def test_package_exports_the_reference_names():
    assert sorted(TK.__all__) == sorted(JK.__all__)
    assert sorted(ops.__all__) == sorted(JOPS.__all__)
    assert sorted(TK.ref.__all__) == sorted(JREF.__all__)
    for name in TK.__all__:
        assert getattr(TK, name) is not None, name
    assert TK.qmatmul is qmatmul and TK.ref.qmatmul_ref is QM.qmatmul_ref


# ---------------------------------------------------------------------------
# qmatmul_op
# ---------------------------------------------------------------------------

def _mats(M, N, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32).astype(jnp.bfloat16)
    y = rng.standard_normal((K, N)).astype(np.float32).astype(jnp.bfloat16)
    return x, y


def _close(got: torch.Tensor, want, x, y, max_frac=0.005):
    """``tests/test_torch_qmatmul.py``'s criterion: ≤ 1 bf16 ulp plus the
    f32 accumulation bound, on at most 0.5% of the outputs."""
    xd, yd = np.asarray(x).astype(np.float64), np.asarray(y).astype(np.float64)
    atol = xd.shape[1] * 2.0 ** -23 * (np.abs(xd) @ np.abs(yd))
    g, w = got.float().numpy(), np.asarray(want).astype(np.float32)
    neq = g != w
    assert neq.mean() <= max_frac, f"{neq.mean():.4%} of outputs differ"
    tol = 2.0 ** -7 * np.maximum(np.abs(w), 2.0 ** -126) + atol
    assert np.all(np.abs(g[neq] - w[neq]) <= tol[neq])


# (M, N, K): aligned shapes take the reference op's Pallas kernel, ragged
# ones its ref.qmatmul_ref fallback; the port's op takes every one alike
@pytest.mark.parametrize("mnk", [(128, 128, 128), (256, 384, 512), (129, 77, 200),
                                 (8, 256, 72)])
def test_qmatmul_op_nearest_matches_reference_op(mnk):
    M, N, K = mnk
    x, y = _mats(M, N, K, M * N + K)
    want = JOPS.qmatmul_op(jnp.asarray(x), jnp.asarray(y))
    got = ops.qmatmul_op(_t(x), _t(y))
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    _close(got, want, x, y)
    # the generator is not consulted under nearest
    assert torch.equal(got, ops.qmatmul_op(_t(x), _t(y), _gen(1)))


@pytest.mark.parametrize("mnk", [(128, 128, 128), (129, 77, 200)])
def test_qmatmul_op_sr_is_the_kernel_on_the_generators_bits(mnk):
    M, N, K = mnk
    x, y = _mats(M, N, K, M + N + K)
    got = ops.qmatmul_op(_t(x), _t(y), _gen(5), stochastic=True)
    bits = random_bits((M, N), generator=_gen(5))
    assert torch.equal(got.view(torch.int16), qmatmul(_t(x), _t(y), bits=bits).view(torch.int16))
    _close(got, JREF.qmatmul_ref(jnp.asarray(x), jnp.asarray(y), bits=jnp.asarray(_u32(bits))),
           x, y)
    again = ops.qmatmul_op(_t(x), _t(y), _gen(5), stochastic=True)
    other = ops.qmatmul_op(_t(x), _t(y), _gen(6), stochastic=True)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    assert not torch.equal(got.view(torch.int16), other.view(torch.int16))


def test_qmatmul_op_sr_is_unbiased():
    """Mean over 512 draws of the SR output ≈ the f32 accumulator it rounds
    (5σ binomial bound per output) and ≈ the exact product."""
    M, N, K, draws = 12, 20, 64, 512
    x, y = _mats(M, N, K, 11)
    tx, ty = _t(x), _t(y)
    gen = _gen(12)
    outs = np.stack([ops.qmatmul_op(tx, ty, gen, stochastic=True).double().numpy()
                     for _ in range(draws)])
    acc = (tx.float() @ ty.float()).double().numpy()
    # acc's bf16 neighbours: truncated toward zero (bits 0), and away (0xFFFF)
    near, away = (QM.qmatmul_ref(tx, ty, bits=torch.full((M, N), b, dtype=torch.int32))
                  .double().numpy() for b in (0, 0xFFFF))
    assert np.all((outs == near) | (outs == away)), "SR must land on the two neighbours"
    span = np.where(away != near, away - near, 1.0)
    theta = (acc - near) / span
    p_hat = (outs.mean(0) - near) / span
    sigma = np.sqrt(theta * (1 - theta) / draws)
    # the 16 bits quantise P[away] to multiples of 2^-16
    assert np.all(np.abs(p_hat - theta) < FIVE_SIGMA * sigma + 2.0 ** -16)
    xd, yd = np.asarray(x).astype(np.float64), np.asarray(y).astype(np.float64)
    e = K * 2.0 ** -23 * (np.abs(xd) @ np.abs(yd))
    assert np.all(np.abs(outs.mean(0) - xd @ yd)
                  < (FIVE_SIGMA * sigma + 2.0 ** -16) * np.abs(span) + e)


def test_qmatmul_op_needs_a_generator_for_sr():
    x = torch.zeros((2, 3), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="generator"):
        ops.qmatmul_op(x, x.T.contiguous(), stochastic=True)


def test_qmatmul_op_on_cpu_launches_nothing():
    x, y = _mats(8, 16, 24, 2)
    before = QM.LAUNCHES
    ops.qmatmul_op(_t(x), _t(y))
    ops.qmatmul_op(_t(x), _t(y), _gen(0), stochastic=True)
    assert QM.LAUNCHES == before


# ---------------------------------------------------------------------------
# sr_cast_op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 4099])
def test_sr_cast_op_is_ref_on_the_generators_bits(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 7).astype(np.float32)
    x[:5] = [np.inf, -np.inf, np.nan, 3.3895e38, -3.3895e38]
    got = ops.sr_cast_op(_t(x), _gen(n))
    bits = random_bits((n,), generator=_gen(n))
    _same(got, JREF.sr_cast_ref(jnp.asarray(x), jnp.asarray(_u32(bits))), "ref.py")
    assert torch.equal(got.view(torch.int16), ops.sr_cast_op(_t(x), _gen(n)).view(torch.int16))
    if n > 5:                           # lanes past the five that SR cannot move
        assert not torch.equal(got.view(torch.int16),
                               ops.sr_cast_op(_t(x), _gen(n + 1)).view(torch.int16))


def test_sr_cast_op_is_unbiased():
    """x = 1 + θ·ulp: the mean of 4096 SR draws lands within 5σ of x."""
    draws, step = 4096, 2.0 ** -7
    thetas = np.array([0.03, 0.25, 0.5, 0.77], np.float64)
    x = torch.from_numpy((1.0 + thetas * step).astype(np.float32)).repeat(draws)
    q = ops.sr_cast_op(x, _gen(3)).double().numpy().reshape(draws, -1)
    assert set(np.unique(q)) <= {1.0, 1.0 + step}
    theta = (x[:len(thetas)].double().numpy() - 1.0) / step
    p_hat = (q.mean(0) - 1.0) / step
    assert np.all(np.abs(p_hat - theta) < FIVE_SIGMA * np.sqrt(theta * (1 - theta) / draws))


# ---------------------------------------------------------------------------
# adamw_update_op, sgd_update_op
# ---------------------------------------------------------------------------

def _state(n: int, seed: int, *, adam: bool) -> dict:
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(a, np.float32).astype(jnp.bfloat16)   # noqa: E731
    w = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    if n >= 5:
        g[:3] = [np.inf, -np.inf, np.nan]
        w[3:5] = [BF16_MAX, -BF16_MAX]
    out = dict(w=bf(w), m=bf(rng.standard_normal(n) * 0.1), g=bf(g),
               c=bf(rng.standard_normal(n) * 2.0 ** -9))
    if adam:
        out["v"] = bf(np.abs(rng.standard_normal(n)) * 0.01)
    return out


@pytest.mark.parametrize("n", [5, 4099])
@pytest.mark.parametrize("stochastic,kahan", VARIANTS)
def test_adamw_update_op_matches_reference(n, stochastic, kahan):
    x = _state(n, n, adam=True)
    t = {k: _t(v) for k, v in x.items()}
    out = ops.adamw_update_op(t["w"], t["m"], t["v"], t["g"], t["c"], _gen(n), ADAMW_HP,
                              stochastic=stochastic, kahan=kahan)
    assert out[0] is t["w"] and out[1] is t["m"] and out[2] is t["v"]     # in place
    assert (out[3] is t["c"]) if kahan else out[3] is None
    bits = jnp.asarray(_u32(random_bits((n,), generator=_gen(n))))
    j = {k: jnp.asarray(v) for k, v in x.items()}
    eager = JREF.fused_adamw_ref(j["w"], j["m"], j["v"], j["g"], c=j["c"] if kahan else None,
                                 bits=bits, stochastic=stochastic, **ADAMW_HP)
    for name, a, r in zip("wmvc", out, eager):
        if r is not None:
            _same(a, r, f"{name} vs eager ref.py")
    # the reference's jitted op, on its own key's bits: fed to the port's kernel
    key = jax.random.PRNGKey(n)
    jitted = JOPS.adamw_update_op(j["w"], j["m"], j["v"], j["g"], j["c"], key, ADAMW_HP,
                                  stochastic=stochastic, kahan=kahan)
    jbits = jax.random.bits(key, shape=(n,), dtype=jnp.uint32)
    eager = JREF.fused_adamw_ref(j["w"], j["m"], j["v"], j["g"], c=j["c"] if kahan else None,
                                 bits=jbits, stochastic=stochastic, **ADAMW_HP)
    t = {k: _t(v) for k, v in x.items()}
    got = fused_adamw(t["w"], t["m"], t["v"], t["g"], c=t["c"] if kahan else None,
                      bits=_t(np.asarray(jbits)), stochastic=stochastic, **ADAMW_HP)
    for name, a, p, r in zip("wmvc", got, jitted, eager):
        if r is not None:
            _same_off_fma_ties(a, p, r, f"{name} vs jitted op")


@pytest.mark.parametrize("n", [5, 4099])
@pytest.mark.parametrize("stochastic,kahan", VARIANTS)
def test_sgd_update_op_matches_reference(n, stochastic, kahan):
    x = _state(n, n + 1, adam=False)
    t = {k: _t(v) for k, v in x.items()}
    out = ops.sgd_update_op(t["w"], t["m"], t["g"], t["c"], _gen(n), SGD_HP,
                            stochastic=stochastic, kahan=kahan)
    assert out[0] is t["w"] and out[1] is t["m"]
    assert (out[2] is t["c"]) if kahan else out[2] is None
    bits = jnp.asarray(_u32(random_bits((n,), generator=_gen(n))))
    j = {k: jnp.asarray(v) for k, v in x.items()}
    eager = JREF.fused_sgd_ref(j["w"], j["m"], j["g"], c=j["c"] if kahan else None, bits=bits,
                               stochastic=stochastic, **SGD_HP)
    for name, a, r in zip("wmc", out, eager):
        if r is not None:
            _same(a, r, f"{name} vs eager ref.py")
    key = jax.random.PRNGKey(n + 1)
    jitted = JOPS.sgd_update_op(j["w"], j["m"], j["g"], j["c"], key, SGD_HP,
                                stochastic=stochastic, kahan=kahan)
    jbits = jax.random.bits(key, shape=(n,), dtype=jnp.uint32)
    eager = JREF.fused_sgd_ref(j["w"], j["m"], j["g"], c=j["c"] if kahan else None, bits=jbits,
                               stochastic=stochastic, **SGD_HP)
    t = {k: _t(v) for k, v in x.items()}
    got = fused_sgd(t["w"], t["m"], t["g"], c=t["c"] if kahan else None,
                    bits=_t(np.asarray(jbits)), stochastic=stochastic, **SGD_HP)
    for name, a, p, r in zip("wmc", got, jitted, eager):
        if r is not None:
            _same_off_fma_ties(a, p, r, f"{name} vs jitted op")


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_update_ops_are_deterministic_per_generator(kind):
    x = _state(4099, 9, adam=True)
    runs = []
    for seed in (21, 21, 22):
        t = {k: _t(v) for k, v in x.items()}
        if kind == "adamw":
            out = ops.adamw_update_op(t["w"], t["m"], t["v"], t["g"], t["c"], _gen(seed),
                                      ADAMW_HP, kahan=True)
        else:
            out = ops.sgd_update_op(t["w"], t["m"], t["g"], t["c"], _gen(seed), SGD_HP,
                                    kahan=True)
        runs.append(out[0].view(torch.int16).clone())
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
