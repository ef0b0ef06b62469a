"""The port's plain update kernels ≡ the reference's, bit for bit, on the CPU.

``sr_cast_ref``, ``fused_adamw_ref`` and ``fused_sgd_ref`` (the plain
PyTorch versions beside the CUDA kernels, which the wrappers run for CPU
tensors) take the same numpy inputs and the same u32 bits as
``repro.kernels.ref`` (eager JAX, one XLA computation per op) and as the
Pallas kernels in interpret mode. Every output must equal ``ref.py`` bit
for bit (NaN lanes: NaN on both sides). All four variants (nearest or SR
× Kahan off or on) run at n ∈ {5, 4099, 50,000}, with non-finite and
near-max lanes. The scalars reach every side as f32 (numpy float32), as
the fused optimizers pass them.

Against the Pallas kernels the port is bitwise equal on every lane where
the Pallas kernel equals its own ``ref.py``. On the few lanes where it
does not, XLA:CPU has contracted a multiply-add of the jitted kernel body
into one FMA (the jitted ``ref.py`` departs on exactly those lanes too):
the "FMA ties" that ``tests/test_kernels.py`` allows, at most
``FMA_TIE_FRAC`` of the lanes. The port and the CUDA kernels never
contract, so they follow ``ref.py`` there.

Then the optimizers: ``optim.fused`` against ``optim.adamw`` /
``optim.sgd`` over three steps from the same per-leaf bits, bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro.kernels.fused_adamw import fused_adamw as pallas_adamw
from repro.kernels.fused_sgd import fused_sgd as pallas_sgd
from repro.kernels.sr_cast import sr_cast as pallas_sr_cast
from repro_torch.core.policy import get_policy
from repro_torch.kernels.fused_adamw import fused_adamw, fused_adamw_ref
from repro_torch.kernels.fused_sgd import fused_sgd, fused_sgd_ref
from repro_torch.kernels.sr_cast import sr_cast, sr_cast_ref
from repro_torch.models import registry as R
from repro_torch.optim import adamw, fused_adamw_optimizer, fused_sgd_optimizer, sgd
from repro_torch.optim.base import StepKey
from repro_torch.tree import tree_leaves, tree_map
from _torch_cpu import one_torch_thread  # noqa: F401

F32 = np.float32
ADAMW_HP = dict(lr=F32(1e-3), b1=F32(0.8984375), b2=F32(0.99609375), eps=F32(1e-8),
                wd=F32(0.01), c1=F32(0.9), c2=F32(0.99609375))
SGD_HP = dict(lr=0.1, momentum=0.9, wd=1e-4)
VARIANTS = [(False, False), (True, False), (False, True), (True, True)]
SIZES = [5, 4099, 50_000]
BF16_MAX = float(jnp.finfo(jnp.bfloat16).max)
FMA_TIE_FRAC = 5e-4


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy (bf16, f32 or u32) → torch, bits moved unchanged."""
    a = np.ascontiguousarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    return torch.from_numpy(a.copy())


def _same(got: torch.Tensor, want, what: str):
    """Bitwise equal bf16, NaN lanes NaN on both sides."""
    want = np.asarray(want)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16, what
    g_bits = got.contiguous().view(torch.int16).numpy()
    w_bits = want.view(np.int16)
    g_nan = torch.isnan(got.float()).numpy()
    w_nan = np.isnan(want.astype(np.float32))
    np.testing.assert_array_equal(g_nan, w_nan, err_msg=f"{what}: NaN lanes")
    bad = (g_bits != w_bits) & ~w_nan
    assert not bad.any(), (f"{what}: {int(bad.sum())} of {bad.size} differ, first at "
                           f"{np.flatnonzero(bad)[:5]}")


def _same_as_pallas(got: torch.Tensor, pallas, ref, what: str):
    """Bitwise equal to the Pallas output, except on its FMA-tie lanes
    (where it departs from ``ref.py``, which ``got`` equals)."""
    pallas, ref = np.asarray(pallas), np.asarray(ref)
    ties = (pallas.view(np.int16) != ref.view(np.int16)) & ~np.isnan(ref.astype(np.float32))
    assert ties.mean() <= FMA_TIE_FRAC, f"{what}: {int(ties.sum())} FMA-tie lanes"
    _same(got[torch.from_numpy(~ties)], pallas[~ties], what)


def _inputs(n: int, seed: int, *, adam: bool):
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(a, np.float32).astype(jnp.bfloat16)   # noqa: E731
    w = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    m = rng.standard_normal(n).astype(np.float32) * 0.1
    v = np.abs(rng.standard_normal(n)).astype(np.float32) * 0.01
    c = rng.standard_normal(n).astype(np.float32) * 2.0 ** -9
    # edge lanes: non-finite gradients, weights at the top of the range
    if n >= 5:
        g[:3] = [np.inf, -np.inf, np.nan]
        w[3:5] = [BF16_MAX, -BF16_MAX]
    out = dict(w=bf(w), m=bf(m), g=bf(g), c=bf(c),
               bits=rng.integers(0, 2**32, size=n, dtype=np.uint32))
    if adam:
        out["v"] = bf(v)
    return out


@pytest.mark.parametrize("n", SIZES)
def test_sr_cast_plain_matches_reference_and_pallas(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 7).astype(np.float32)
    if n >= 5:
        x[:5] = [np.inf, -np.inf, np.nan, 3.3895e38, -3.3895e38]   # near max may carry to inf
    bits = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    got = sr_cast_ref(_t(x), _t(bits))
    _same(got, JREF.sr_cast_ref(jnp.asarray(x), jnp.asarray(bits)), "ref.py")
    _same(got, pallas_sr_cast(jnp.asarray(x), jnp.asarray(bits), interpret=True), "pallas")
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(sr_cast(_t(x), _t(bits)).view(torch.int16), got.view(torch.int16))


def test_sr_cast_carries_into_inf_like_the_reference():
    # the largest finite f32 below bf16 max's upper neighbour rounds up to
    # inf with full bits, and down to bf16 max with zero bits
    x = np.array([np.finfo(np.float32).max, 3.3961e38], np.float32)
    for b in (0, 0xFFFF):
        bits = np.full(2, b, np.uint32)
        got = sr_cast_ref(_t(x), _t(bits))
        _same(got, JREF.sr_cast_ref(jnp.asarray(x), jnp.asarray(bits)), f"bits {b:#x}")
    assert torch.isinf(sr_cast_ref(_t(x), _t(np.full(2, 0xFFFF, np.uint32)))).all()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("stochastic,kahan", VARIANTS)
def test_fused_adamw_plain_matches_reference_and_pallas(n, stochastic, kahan):
    x = _inputs(n, n, adam=True)
    c = x["c"] if kahan else None
    bits = x["bits"] if stochastic else None
    j = {k: jnp.asarray(v) for k, v in x.items()}
    jkw = dict(c=None if c is None else j["c"], bits=None if bits is None else j["bits"],
               stochastic=stochastic, **ADAMW_HP)
    want_ref = JREF.fused_adamw_ref(j["w"], j["m"], j["v"], j["g"], **jkw)
    want_pl = pallas_adamw(j["w"], j["m"], j["v"], j["g"], interpret=True, **jkw)
    t = {k: _t(v) for k, v in x.items()}
    got = fused_adamw_ref(t["w"], t["m"], t["v"], t["g"], c=t["c"] if kahan else None,
                          bits=t["bits"] if stochastic else None, stochastic=stochastic,
                          **ADAMW_HP)
    for name, a, r, p in zip("wmvc", got, want_ref, want_pl):
        if r is None:
            assert a is None and p is None
            continue
        _same(a, r, f"{name} vs ref.py")
        _same_as_pallas(a, p, r, f"{name} vs pallas")
    # the in-place wrapper on CPU tensors writes the same values
    fused_adamw(t["w"], t["m"], t["v"], t["g"], c=t["c"] if kahan else None,
                bits=t["bits"] if stochastic else None, stochastic=stochastic, **ADAMW_HP)
    for name, a, buf in zip("wmvc", got, (t["w"], t["m"], t["v"], t["c"])):
        if a is not None:
            _same(buf, np.asarray(want_ref["wmvc".index(name)]), f"in-place {name}")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("stochastic,kahan", VARIANTS)
def test_fused_sgd_plain_matches_reference_and_pallas(n, stochastic, kahan):
    x = _inputs(n, n + 1, adam=False)
    c = x["c"] if kahan else None
    bits = x["bits"] if stochastic else None
    j = {k: jnp.asarray(v) for k, v in x.items()}
    jkw = dict(c=None if c is None else j["c"], bits=None if bits is None else j["bits"],
               stochastic=stochastic, **SGD_HP)
    want_ref = JREF.fused_sgd_ref(j["w"], j["m"], j["g"], **jkw)
    want_pl = pallas_sgd(j["w"], j["m"], j["g"], interpret=True, **jkw)
    t = {k: _t(v) for k, v in x.items()}
    got = fused_sgd_ref(t["w"], t["m"], t["g"], c=t["c"] if kahan else None,
                        bits=t["bits"] if stochastic else None, stochastic=stochastic,
                        **SGD_HP)
    for name, a, r, p in zip("wmc", got, want_ref, want_pl):
        if r is None:
            assert a is None and p is None
            continue
        _same(a, r, f"{name} vs ref.py")
        _same_as_pallas(a, p, r, f"{name} vs pallas")
    fused_sgd(t["w"], t["m"], t["g"], c=t["c"] if kahan else None,
              bits=t["bits"] if stochastic else None, stochastic=stochastic, **SGD_HP)
    for name, buf in zip("wmc", (t["w"], t["m"], t["c"])):
        r = want_ref["wmc".index(name)]
        if r is not None:
            _same(buf, np.asarray(r), f"in-place {name}")


def test_fused_kahan_accumulates_small_updates():
    """Port of tests/test_kernels.py::test_fused_kahan_accumulates_small_updates:
    tiny updates cancelled by nearest rounding are recovered by the Kahan
    variant of the fused kernel's plain version."""
    n = 256
    w = torch.ones(n, dtype=torch.bfloat16)
    w_n = w.clone()
    c = torch.zeros(n, dtype=torch.bfloat16)
    g = torch.full((n,), 1e-4, dtype=torch.bfloat16)
    for _ in range(500):
        fused_sgd(w_n, torch.zeros(n, dtype=torch.bfloat16), g, c=None, bits=None,
                  stochastic=False, lr=1.0, momentum=0.0)
        fused_sgd(w, torch.zeros(n, dtype=torch.bfloat16), g, c=c, bits=None,
                  stochastic=False, lr=1.0, momentum=0.0)
    assert float(w_n[0]) == 1.0                      # nearest: halted
    assert abs(float(w[0]) - (1 - 0.05)) < 0.01      # kahan: moved


def test_wrappers_need_bits_for_sr():
    w = torch.zeros(4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs bits"):
        fused_adamw(w, w.clone(), w.clone(), w.clone(), lr=1e-3, b1=0.9, b2=0.99,
                    eps=1e-8, wd=0.0, c1=0.9, c2=0.99, stochastic=True)
    with pytest.raises(ValueError, match="needs bits"):
        fused_sgd(w, w.clone(), w.clone(), lr=0.1, stochastic=True)


# ---------------------------------------------------------------------------
# optim.fused ≡ optim.adamw / optim.sgd, same per-leaf bits
# ---------------------------------------------------------------------------

def _flat(tree) -> list:
    """Tensors of a tree of dicts, tuples and NamedTuples (None skipped)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return tree_leaves(tree)
    if isinstance(tree, tuple):
        return [t for part in tree for t in _flat(part)]
    return [tree]


def _model(seed=0):
    cfg = R.get_config("qwen2.5-3b").reduced()
    params = R.init(cfg, seed, torch.bfloat16, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    grads = [tree_map(lambda w: (torch.randn(w.shape, generator=gen) * 0.05).to(torch.bfloat16),
                      params) for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("policy_name", ["bf16_standard", "bf16_sr", "bf16_kahan",
                                         "bf16_sr_kahan"])
@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_fused_optimizer_matches_plain_optimizer(policy_name, kind):
    policy = get_policy(policy_name)
    if kind == "adamw":
        plain = adamw(policy, b2=0.997, weight_decay=0.01)
        fused = fused_adamw_optimizer(policy, b2=0.997, weight_decay=0.01)
    else:
        plain = sgd(policy, momentum=0.9, weight_decay=1e-4)
        fused = fused_sgd_optimizer(policy, momentum=0.9, weight_decay=1e-4)
    params, grads = _model()
    p_plain = tree_map(torch.clone, params)
    p_fused = tree_map(torch.clone, params)
    s_plain, s_fused = plain.init(p_plain), fused.init(p_fused)
    for step, g in enumerate(grads):
        key = StepKey(7, step)
        p_plain, s_plain = plain.update(g, s_plain, p_plain, step=step, key=key, lr=3e-3)
        p_fused, s_fused = fused.update(g, s_fused, p_fused, step=step, key=key, lr=3e-3)
        flat_plain, flat_fused = _flat((p_plain, s_plain)), _flat((p_fused, s_fused))
        assert len(flat_plain) == len(flat_fused) > len(tree_leaves(params))
        for a, b in zip(flat_plain, flat_fused):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16)), (step, kind)
    moved = sum(int((a != b).sum()) for a, b in zip(tree_leaves(p_plain), tree_leaves(params)))
    assert moved > 0
