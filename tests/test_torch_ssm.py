"""The port's recurrences ≡ the reference (``repro.models.ssm``, ``rglru``).

``linear_recurrence`` against the reference's (chunked ``lax.scan`` over
``jax.lax.associative_scan``) at chunk boundaries and with a padded tail:
in f32 within ``F32_TOL`` (XLA:CPU contracts the combine's ``ay·bx + by``
into an FMA inside the compiled scan, C8; the port rounds the product: an
f32 ulp or two at |h| ~ 4), in bf16 — every combine rounded, the reference
compiled without excess precision (C7) — bitwise, and against a sequential
f64 loop. The port repeats the reference's odd/even recursion (held
bitwise on its ``associative_scan`` against a numpy transcription of
JAX's recursion).
``causal_conv1d`` fed chunk by chunk with its state equals one call on
the whole sequence. Mamba's and RG-LRU's decode steps, token by token from
a zero state, and their full-sequence blocks, each bitwise equal to the
reference's on these inputs; the f32 state within ``H_TOL`` (XLA's FMA in
``a·h + b``, C8); the steps against the full-sequence block within
``STEP_TOL`` (Mamba's full sequence carries its scan in bf16, its decode
step in f32 — the reference's own difference, a bf16 ulp of outputs ~0.3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.core.qarith import QArith as JQArith
from repro.models import registry as JR
from repro.models import rglru as JG
from repro.models import ssm as JS
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse fixture)
from repro_torch.convert import from_jax_params
from repro_torch.core.policy import get_policy as t_get_policy
from repro_torch.core.qarith import QArith as TQArith
from repro_torch.models import registry as TR
from repro_torch.models import rglru as TG
from repro_torch.models import ssm as TS

F32_TOL = 2e-6
STEP_TOL = 4e-3
H_TOL = 1e-6
POLICY = "bf16_standard"


def _ab(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    return a.astype(dtype), b.astype(dtype)


def _seq_f64(a, b):
    h = np.zeros(a.shape[:1] + a.shape[2:])
    out = []
    for t in range(a.shape[1]):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        out.append(h)
    return np.stack(out, 1)


def _np_assoc(a, b):
    """JAX's associative_scan recursion, transcribed in numpy (f32, each
    op rounded)."""
    n = a.shape[1]
    if n < 2:
        return a, b

    def comb(x, y):
        return x[0] * y[0], y[0] * x[1] + y[1]
    ra, rb = comb((a[:, 0:n - 1:2], b[:, 0:n - 1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = _np_assoc(ra, rb)
    ea, eb = comb((oa[:, :-1], ob[:, :-1]) if n % 2 == 0 else (oa, ob),
                  (a[:, 2::2], b[:, 2::2]))
    ea, eb = np.concatenate([a[:, :1], ea], 1), np.concatenate([b[:, :1], eb], 1)

    def inter(x, y):
        out = np.empty((x.shape[0], x.shape[1] + y.shape[1]) + x.shape[2:], x.dtype)
        out[:, 0::2], out[:, 1::2] = x, y
        return out
    return inter(ea, oa), inter(eb, ob)


@pytest.mark.parametrize("S", [1, 2, 7, 16, 33])
def test_associative_scan_is_jax_recursion_bitwise(S):
    a, b = _ab((2, S, 3), S)
    want = _np_assoc(a, b)
    got = TS.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("S,chunk", [(32, 8), (37, 8), (37, 16), (5, 256), (64, 64)])
def test_linear_recurrence_matches_reference_f32(S, chunk):
    a, b = _ab((2, S, 4, 3), S + chunk)
    h0 = np.random.default_rng(1).normal(size=(2, 4, 3)).astype(np.float32)
    jy, jh = JS.linear_recurrence(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), chunk=chunk)
    ty, th = TS.linear_recurrence(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(h0), chunk=chunk)
    assert tuple(ty.shape) == (2, S, 4, 3) and tuple(th.shape) == (2, 4, 3)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=F32_TOL, atol=F32_TOL)
    ref = _seq_f64(np.concatenate([np.ones_like(a[:, :1]), a], 1),
                   np.concatenate([h0[:, None], b], 1))[:, 1:]
    np.testing.assert_allclose(ty.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S,chunk", [(32, 8), (37, 16)])
def test_linear_recurrence_matches_reference_bf16(S, chunk):
    a, b = _ab((2, S, 8), 7 * S)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    fn = jax.jit(lambda a, b: JS.linear_recurrence(a, b, chunk=chunk)).lower(ja, jb).compile(
        compiler_options={"xla_allow_excess_precision": False})
    jy, _ = fn(ja, jb)
    ta, tb = torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16)
    ty, _ = TS.linear_recurrence(ta, tb, chunk=chunk)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(ty.float().numpy(), np.asarray(jy, np.float32))


def test_causal_conv_carries_its_state():
    qa = TQArith(t_get_policy(POLICY))
    p = TS.conv_init(torch.Generator().manual_seed(0), 4, 16, torch.bfloat16)
    p["b"] = torch.full((16,), 0.25, dtype=torch.bfloat16)
    x = torch.randn((2, 11, 16), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    whole, state_all = TS.causal_conv1d(qa, p, x)
    state, parts = None, []
    for lo, hi in ((0, 3), (3, 4), (4, 11)):
        y, state = TS.causal_conv1d(qa, p, x[:, lo:hi], state)
        parts.append(y)
    assert torch.equal(torch.cat(parts, 1), whole) and torch.equal(state, state_all)
    assert torch.equal(state, x[:, -3:])
    # against the reference on the same inputs, with a nonzero history
    jp = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) for k, v in p.items()}
    hist = torch.randn((2, 3, 16), generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    jy, js = JS.causal_conv1d(JQArith(j_get_policy(POLICY)), jp,
                              jnp.asarray(x.float().numpy(), jnp.bfloat16),
                              jnp.asarray(hist.float().numpy(), jnp.bfloat16))
    ty, ts = TS.causal_conv1d(qa, p, x, hist)
    np.testing.assert_array_equal(ty.float().numpy(), np.asarray(jy, np.float32))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js, np.float32))


def _block(arch, kind):
    """Both configs, the reference's and the port's (converted) mixer
    weights of the first block of ``kind``, and the policy's QAriths."""
    jcfg, tcfg = JR.get_config(arch).reduced(), TR.get_config(arch).reduced()
    jpol, tpol = j_get_policy(POLICY), t_get_policy(POLICY)
    params = JR.init(jcfg, jax.random.PRNGKey(3), jpol.param_dtype)
    mixer = jax.tree_util.tree_map(lambda t: t[0], params["layers"]["b0"]["mixer"])
    tree = {"layers": {"b0": {"mixer": jax.tree_util.tree_map(
        lambda t: np.asarray(t)[None], mixer)}}}
    tp = from_jax_params(tree, device="cpu")["layers"]["b0"]["mixer"]
    tp = jax.tree_util.tree_map(lambda t: t[0], tp)
    return jcfg, tcfg, mixer, tp, JQArith(jpol), TQArith(tpol)


_STEPS = {"mamba": (JS.mamba_apply, JS.mamba_decode_step, TS.mamba_apply,
                    TS.mamba_decode_step),
          "rec": (JG.rglru_apply, JG.rglru_decode_step, TG.rglru_apply,
                  TG.rglru_decode_step)}


@pytest.mark.parametrize("arch,kind", [("falcon-mamba-7b", "mamba"),
                                       ("recurrentgemma-2b", "rec")])
def test_decode_steps_follow_the_full_sequence(arch, kind):
    jcfg, tcfg, jp, tp, jqa, tqa = _block(arch, kind)
    j_apply, j_step, t_apply, t_step = _STEPS[kind]
    B, S = 2, 12
    x = (np.random.default_rng(5).normal(size=(B, S, tcfg.d_model)) * 0.5).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    width = tcfg.d_inner if kind == "mamba" else tcfg.lru_width
    h_shape = (B, tcfg.d_inner, tcfg.ssm_state) if kind == "mamba" else (B, width)
    tstate = {"conv": torch.zeros((B, tcfg.ssm_conv - 1, width), dtype=torch.bfloat16),
              "h": torch.zeros(h_shape)}
    jstate = {"conv": jnp.zeros((B, tcfg.ssm_conv - 1, width), jnp.bfloat16),
              "h": jnp.zeros(h_shape, jnp.float32)}
    jstep = jax.jit(lambda p, x, s: j_step(jqa, p, x, jcfg, s)).lower(
        jp, xj[:, :1], jstate).compile(compiler_options={"xla_allow_excess_precision": False})
    steps, jsteps = [], []
    for t in range(S):
        y, tstate = t_step(tqa, tp, xt[:, t:t + 1], tcfg, tstate)
        jy, jstate = jstep(jp, xj[:, t:t + 1], jstate)
        steps.append(y)
        jsteps.append(np.asarray(jy, np.float32))
    steps = torch.cat(steps, 1).float().numpy()
    full = t_apply(tqa, tp, xt, tcfg).float().numpy()
    assert np.isfinite(steps).all()
    np.testing.assert_array_equal(steps, np.concatenate(jsteps, 1))
    np.testing.assert_allclose(tstate["h"].numpy(), np.asarray(jstate["h"]),
                               atol=H_TOL, rtol=H_TOL)
    np.testing.assert_allclose(steps, full, atol=STEP_TOL, rtol=STEP_TOL)
    jfull = jax.jit(lambda p, x: j_apply(jqa, p, x, jcfg)).lower(jp, xj).compile(
        compiler_options={"xla_allow_excess_precision": False})(jp, xj)
    np.testing.assert_array_equal(full, np.asarray(jfull, np.float32))


def test_tree_sum_is_row_independent_and_exact_on_integers():
    t = torch.arange(3 * 13, dtype=torch.float32).reshape(3, 13)
    assert torch.equal(TS.tree_sum(t), t.sum(-1))
    r = torch.randn((64, 16), generator=torch.Generator().manual_seed(0))
    assert torch.equal(TS.tree_sum(r[:5]), TS.tree_sum(r)[:5])
    np.testing.assert_allclose(TS.tree_sum(r).numpy(), r.sum(-1).numpy(), rtol=1e-5, atol=1e-6)


def test_mamba_init_matches_the_reference_layout():
    jcfg, tcfg = JR.get_config("falcon-mamba-7b").reduced(), TR.get_config(
        "falcon-mamba-7b").reduced()
    jp = JS.mamba_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tp = TS.mamba_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    # the deterministic leaves are the reference's (A_log = log n: the two
    # f32 logs differ in the last ulp on some n, C5)
    want = np.asarray(jp["A_log"])
    assert np.all(np.abs(tp["A_log"].numpy() - want) <= np.spacing(want))
    np.testing.assert_array_equal(tp["D_skip"].numpy(), np.asarray(jp["D_skip"]))
    dt = TS.softplus(tp["dt_proj"]["bias"].float())
    assert float(dt.min()) >= 1e-3 * 0.99 and float(dt.max()) <= 0.1 * 1.01
    # recurrentgemma's Λ: a = exp(-8·softplus(Λ)) in [0.9, 0.999]
    lam = TG.rglru_init(torch.Generator().manual_seed(0),
                        dataclasses.replace(tcfg, lru_width=64), torch.bfloat16)["lambda"]
    a = torch.exp(-8.0 * TS.softplus(lam))
    assert lam.dtype == torch.float32
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
