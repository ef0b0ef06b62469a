"""Port ≡ reference for stochastic rounding, the optimizers and the schedules.

* ``round_stochastic``: every branch — the e8 bit trick (bf16, bf14, bf12,
  bf10), fp16 by explicit neighbours, and the small-exponent formats
  (e5m2, e4m3) — equals the reference's quantizer fed the same noise, bit
  for bit, on inputs that include ±0, subnormals, the top of the range,
  ±inf and NaN. The straight-through gradient equals the reference's
  (``jax.vjp``) for the e8 and small-exponent branches and for
  ``round_nearest`` on the simulated grids. (The reference's fp16 branch
  is built from selects, so its gradient is 1 or 0 by the neighbour
  chosen; the port passes it through. SR runs only in the optimizer, under
  ``no_grad``, so no path differentiates it.)
* SR drawn from torch's own generator is unbiased: the mean of 4096
  draws at 1 + θ·ulp (and at θ·sub_spacing on the small-exponent grids)
  lands within 5σ of the binomial mean, as tests/test_formats_properties.py
  requires of the reference.
* ``adamw`` and ``sgd`` (with and without Nesterov) under every bf16 and
  master-weight preset, fp32, ``fp16_kahan`` and ``bf14_sr`` take three steps from one state, handed over by
  ``from_jax_train_state``, with the reference's per-leaf SR bits (or
  fp16 uniforms) passed through ``GivenKey``: every parameter, moment,
  Kahan buffer and c₁/c₂ is bitwise equal after every step.
* The five schedules: the linear ones bitwise; the cosine and power ones
  within 2 f32 ulps of the peak rate (the two frameworks' f32 ``cos`` and
  ``pow`` differ in the last ulp, and ``1 + cos`` near the end of the
  decay cancels, so the ulp is taken at the peak).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import get_policy as j_get_policy
from repro.models import registry as JR
from repro.optim import adamw as j_adamw
from repro.optim import init_params_for_policy as j_init_params_for_policy
from repro.optim import schedule as JSCH
from repro.optim import sgd as j_sgd
from repro.train.train_state import make_train_state as j_make_train_state
from repro_torch.convert import from_jax_train_state
from repro_torch.core import formats as TF
from repro_torch.core.policy import get_policy
from repro_torch.optim import GivenKey, adamw, sgd
from repro_torch.optim import schedule as TSCH
from repro_torch.tree import tree_leaves
from _torch_cpu import one_torch_thread  # noqa: F401

N = 4099
E8 = ["bf16", "bf14", "bf12", "bf10"]
SMALL_EXP = ["e5m2", "e4m3"]


def _x(seed=0, n=N) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))).astype(np.float32)
    x[:10] = [0.0, -0.0, 1e-40, -1e-40, 3.3e38, -3.3e38, np.inf, -np.inf, np.nan, 65504.0]
    return x


def _noise(seed=1, n=N) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


def _u(seed=2, n=N) -> np.ndarray:
    return np.random.default_rng(seed).random(n, dtype=np.float32)


def _bits_of(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(a.copy())


def _bitwise(got: torch.Tensor, want, what=""):
    """Equal bit patterns, NaN lanes NaN on both sides."""
    if got.dtype == torch.bfloat16:
        g = got.contiguous().view(torch.int16).numpy().view(np.uint16)
    elif got.dtype == torch.float16:
        g = got.contiguous().view(torch.int16).numpy().view(np.uint16)
    else:
        g = got.contiguous().numpy().view(np.uint32)
    w = _bits_of(want)
    nan = np.isnan(np.asarray(want, np.float32))
    np.testing.assert_array_equal(torch.isnan(got.float()).numpy(), nan, err_msg=what)
    bad = (g != w) & ~nan
    assert not bad.any(), f"{what}: {int(bad.sum())}/{bad.size} differ at {np.flatnonzero(bad)[:5]}"


# ---------------------------------------------------------------------------
# round_stochastic, every branch, same noise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fname", E8)
def test_sr_e8_matches_reference(fname):
    fmt = TF.FORMATS[fname]
    x, noise = _x(), _noise()
    want = JF._ste_stochastic(fmt.shift)(jnp.asarray(x),
                                         jnp.asarray(noise & np.uint32(2**fmt.shift - 1)))
    _bitwise(TF.round_stochastic(_t(x), fmt, noise=_t(noise)), want, fname)


def test_sr_fp16_matches_reference():
    key = jax.random.PRNGKey(3)
    x = _x() * np.float32(2.0**-20)                 # into fp16's range and subnormals
    x[10:20] = [65504.0, -65504.0, 65520.0, 7e4, 6e-8, -6e-8, 3e-8, 1e-9, 0.5, 1.0]
    want = JF._round_stochastic_fp16(jnp.asarray(x), key)
    u = np.asarray(jax.random.uniform(key, shape=x.shape, dtype=jnp.float32))
    _bitwise(TF.round_stochastic(_t(x), TF.FP16, u=_t(u)), want, "fp16")


@pytest.mark.parametrize("fname", SMALL_EXP)
def test_sr_small_exp_matches_reference(fname):
    fmt = TF.FORMATS[fname]
    x = _x() * np.float32(2.0**-60)
    x[10:14] = [fmt.max_finite, -fmt.max_finite, 2 * fmt.max_finite, fmt.sub_spacing / 3]
    noise, u = _noise(), _u()
    want = JF._ste_stochastic_small_exp(fmt)(
        jnp.asarray(x), jnp.asarray(noise & np.uint32(2**fmt.shift - 1)), jnp.asarray(u))
    _bitwise(TF.round_stochastic(_t(x), fmt, noise=_t(noise), u=_t(u)), want, fname)


def test_stochastic_round_bf16_is_native_bf16():
    x, noise = _x(), _noise()
    got = TF.stochastic_round_bf16(_t(x), noise=_t(noise))
    want = JF._ste_stochastic(16)(jnp.asarray(x), jnp.asarray(noise & np.uint32(0xFFFF)))
    assert got.dtype == torch.bfloat16
    _bitwise(got, np.asarray(want).astype(jnp.bfloat16), "bf16")


@pytest.mark.parametrize("fname", E8[1:] + SMALL_EXP)
def test_straight_through_gradients_match_reference(fname):
    fmt = TF.FORMATS[fname]
    jfmt = JF.FORMATS[fname]
    x = np.random.default_rng(4).standard_normal(64).astype(np.float32)
    ct = np.random.default_rng(5).standard_normal(64).astype(np.float32)
    noise = _noise(n=64) & np.uint32(2**fmt.shift - 1)
    u = _u(n=64)
    if fmt.is_f32_exponent:
        j_sr = lambda a: JF._ste_stochastic(fmt.shift)(a, jnp.asarray(noise))   # noqa: E731
    else:
        j_sr = lambda a: JF._ste_stochastic_small_exp(jfmt)(a, jnp.asarray(noise),  # noqa: E731
                                                            jnp.asarray(u))
    for name, j_fn, t_fn in [
        ("round_stochastic", j_sr,
         lambda a: TF.round_stochastic(a, fmt, noise=_t(noise), u=_t(u))),
        ("round_nearest", lambda a: JF.round_nearest(a, jfmt),
         lambda a: TF.round_nearest(a, fmt)),
    ]:
        _, vjp = jax.vjp(j_fn, jnp.asarray(x))
        xt = _t(x).requires_grad_(True)
        t_fn(xt).backward(_t(ct))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]),
                                      err_msg=name)
        np.testing.assert_array_equal(xt.grad.numpy(), ct, err_msg=name)


# ---------------------------------------------------------------------------
# SR unbiased with torch's generator (5σ, as the reference's property test)
# ---------------------------------------------------------------------------

N_SAMPLES = 4096


@pytest.mark.parametrize("fname", E8 + ["fp16"] + SMALL_EXP)
@pytest.mark.parametrize("theta", [0.07, 0.31, 0.46])
def test_sr_unbiased_at_sub_ulp_offsets(fname, theta):
    fmt = TF.FORMATS[fname]
    step = float(TF.ulp(torch.tensor(1.0), fmt))
    x32 = np.float32(1.0 + theta * step)
    theta_eff = (float(x32) - 1.0) / step
    assert float(TF.round_nearest(torch.tensor(x32), fmt)) == 1.0
    gen = torch.Generator().manual_seed(int(theta * 1000) + len(fname))
    q = TF.round_stochastic(torch.full((N_SAMPLES,), float(x32)), fmt,
                            generator=gen).double().numpy()
    assert set(np.unique(q)) <= {1.0, 1.0 + step}
    p_hat = (q.mean() - 1.0) / step
    sigma = math.sqrt(theta_eff * (1 - theta_eff) / N_SAMPLES)
    assert abs(p_hat - theta_eff) < 5.0 * sigma, (p_hat, theta_eff, sigma)


@pytest.mark.parametrize("fname", ["fp16"] + SMALL_EXP)
def test_sr_unbiased_on_subnormal_grid(fname):
    fmt = TF.FORMATS[fname]
    sp = fmt.sub_spacing
    x32 = np.float32(0.37 * sp)
    theta_eff = float(x32) / sp
    gen = torch.Generator().manual_seed(11)
    q = TF.round_stochastic(torch.full((N_SAMPLES,), float(x32)), fmt,
                            generator=gen).double().numpy()
    assert set(np.unique(q)) <= {0.0, sp}
    sigma = math.sqrt(theta_eff * (1 - theta_eff) / N_SAMPLES)
    assert abs(q.mean() / sp - theta_eff) < 5.0 * sigma


# ---------------------------------------------------------------------------
# adamw / sgd ≡ reference, 3 steps from one state, every preset
# ---------------------------------------------------------------------------

def _reference_noise(policy, key, params):
    """The per-leaf randomness the reference's ``leafwise`` draws for
    ``key``: SR bits (e8 grids) or uniforms (fp16), in leaf order."""
    leaves = jax.tree_util.tree_leaves(params)
    keys = jax.random.split(key, len(leaves))
    fmt = policy.param_format
    if fmt.name == "fp16":
        return GivenKey([None] * len(leaves),
                        [_t(np.asarray(jax.random.uniform(k, w.shape, jnp.float32)))
                         for k, w in zip(keys, leaves)])
    return GivenKey([_t(np.asarray(jax.random.bits(k, w.shape, jnp.uint32)))
                     for k, w in zip(keys, leaves)])


def _state_leaves(state):
    out = []
    for part in state:
        if part is None:
            continue
        out += tree_leaves(part) if isinstance(part, dict) else [part]
    return out


# every bf16 and master-weight preset, fp32, and one preset of each
# simulated grid (fp16 carried in f32 with uniforms for SR; bf14's e8 bits)
POLICIES = ["fp32", "mixed", "bf16_master", "bf16_standard", "bf16_sr", "bf16_kahan",
            "bf16_sr_kahan", "fp16_kahan", "bf14_sr"]


@pytest.mark.parametrize("kind", ["adamw", "sgd", "sgd_nesterov"])
@pytest.mark.parametrize("policy_name", POLICIES)
def test_optimizer_three_steps_match_reference(policy_name, kind):
    jp, tp = j_get_policy(policy_name), get_policy(policy_name)
    if kind == "adamw":
        jopt = j_adamw(jp, b2=0.997, weight_decay=0.01)
        topt = adamw(tp, b2=0.997, weight_decay=0.01)
    else:
        nest = kind == "sgd_nesterov"
        jopt = j_sgd(jp, momentum=0.9, weight_decay=1e-4, nesterov=nest)
        topt = sgd(tp, momentum=0.9, weight_decay=1e-4, nesterov=nest)
    # the reduced model's leaves, each cut to one (4, 256) block: the update
    # is elementwise, and one shape keeps the reference's eager op
    # compilations to a few per dtype
    cfg = JR.get_config("qwen2.5-3b").reduced()
    params = jax.tree_util.tree_map(
        lambda w: jnp.resize(w.ravel(), (4, 256)),
        j_init_params_for_policy(JR.init(cfg, jax.random.PRNGKey(0), jnp.float32), jp))
    jstate = j_make_train_state(params, jopt)
    tstate = from_jax_train_state(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    assert type(tstate.opt_state).__name__ == type(jstate.opt_state).__name__
    rng = np.random.default_rng(9)
    for step in range(3):
        g_np = jax.tree_util.tree_map(
            lambda w: (rng.standard_normal(w.shape) * 0.05).astype(jp.compute_dtype), params)
        key = jax.random.fold_in(jax.random.PRNGKey(5), step)
        lr = np.float32(1e-3 * (step + 1))
        p_j, s_j = jopt.update(jax.tree_util.tree_map(jnp.asarray, g_np), jstate.opt_state,
                               jstate.params, step=step, key=key, lr=jnp.float32(lr))
        jstate = jstate._replace(params=p_j, opt_state=s_j)
        g_t = jax.tree_util.tree_map(_t, g_np)
        p_t, s_t = topt.update(g_t, tstate.opt_state, tstate.params, step=step,
                               key=_reference_noise(tp, key, params), lr=float(lr))
        tstate = tstate._replace(params=p_t, opt_state=s_t)
        want = jax.tree_util.tree_leaves(p_j) + _state_leaves(s_j)
        got = tree_leaves(p_t) + _state_leaves(s_t)
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert str(a.dtype).split(".")[-1] == str(b.dtype), i
            _bitwise(a, b, f"{policy_name} {kind} step {step} leaf {i}")


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

SCHEDULES = [
    ("constant", (3e-3,), 0),
    ("linear_warmup_linear_decay", (1e-3, 7, 50), 0),
    ("step_decay", (0.1, (10, 20, 35)), 2),
    ("cosine_decay", (3e-3, 40, 1e-5), 2),
    ("linear_warmup_cosine", (3e-3, 5, 60), 2),
]


@pytest.mark.parametrize("name,args,ulps", SCHEDULES)
def test_schedules_match_reference(name, args, ulps):
    j_fn, t_fn = getattr(JSCH, name)(*args), getattr(TSCH, name)(*args)
    for step in range(0, 70):
        want = np.float32(j_fn(jnp.int32(step)))
        got = t_fn(step)
        assert isinstance(got, float) and np.float32(got) == got
        assert abs(np.float32(got) - want) <= ulps * np.spacing(np.float32(args[0])), \
            (step, got, want)
    if name == "linear_warmup_cosine":
        assert t_fn(0) == 0.0 and t_fn(1) > 0.0
