"""The port's training path ≡ the reference, on the CPU, at the reduced size.

* ``flash_attention``: the output and all three input gradients against
  ``jax.vjp`` of the reference, with a chunk shorter than the keys (the
  online softmax across chunks), GQA, a window and a softcap. Under
  ``fp32`` within ``FLASH_TOL_F32`` (f32 ``exp``/``log``/``tanh`` differ in
  the last ulp between the frameworks, and sums run in another order).
  Under ``bf16`` within ``FLASH_TOL_BF16`` of each tensor's largest
  magnitude: p and ds are rounded to bf16 before their products, so an
  f32-ulp difference can flip one rounding.
* ``forward_logits`` and the first ``make_train_step``'s loss and
  ``grad_norm`` against the reference compiled with
  ``xla_allow_excess_precision=False`` (XLA:CPU otherwise keeps some bf16
  intermediates in f32, skipping roundings the FMAC model prescribes), and
  5-step loss trajectories from one state (``from_jax_train_state``) over
  one batch list, under ``fp32`` and ``bf16_kahan``. The tolerances in
  ``STEP_TOL`` cover the order of f32 sums and the last-ulp differences of
  ``exp``/``rsqrt``/``silu`` that can flip a bf16 rounding somewhere in the
  3-layer stack.
* ``grad_accum=2`` against one batch of twice the size (f32: the same
  sums in another grouping).
* ``lm_batches``: deterministic, resumable, and — fed the reference's
  uniforms — the reference's grammar token for token.
* ``python -m repro_torch.launch.train --reduced --device cpu`` trains 30
  steps and the loss falls; without a card, asking for CUDA raises.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.core.qarith import QArith as JQArith
from repro.data.synthetic import TokenStream as JTokenStream
from repro.models import layers as JL
from repro.models import registry as JR
from repro.optim import adamw as j_adamw
from repro.optim import constant as j_constant
from repro.train.step import make_train_step as j_make_train_step
from repro.train.train_state import make_train_state as j_make_train_state
from repro_torch.convert import from_jax_params, from_jax_train_state
from repro_torch.core.policy import get_policy
from repro_torch.core.qarith import QArith
from repro_torch.data.synthetic import TokenStream, lm_batches
from repro_torch.dist.partition import Placement, default_placement, param_specs
from repro_torch.dist.transport import make_transport
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as TL
from repro_torch.models import registry as R
from repro_torch.optim import adamw, constant
from repro_torch.train.step import make_eval_step, make_train_step
from repro_torch.train.train_state import make_train_state
from repro_torch.tree import tree_leaves
from _torch_cpu import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
FLASH_TOL_F32 = 2e-5
FLASH_TOL_BF16 = 2.0 ** -6
# measured: fp32 logits 4.4e-6, loss 1.8e-6 rel, grad_norm 1.3e-7 rel;
# bf16_kahan logits 6.5e-3, loss 2.2e-4 rel, grad_norm 2.2e-4 rel
STEP_TOL = {"fp32": dict(loss=1e-5, grad_norm=1e-5, logits=2e-5),
            "bf16_kahan": dict(loss=2e-3, grad_norm=2e-3, logits=2e-2)}
B, S, CHUNK = 2, 32, 16
NO_EXCESS = {"xla_allow_excess_precision": False}


def _t(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy_name", ["fp32", "bf16_standard"])
@pytest.mark.parametrize("kw", [dict(), dict(window=24), dict(softcap=30.0),
                                dict(window=9, softcap=5.0)])
def test_flash_attention_and_grads_match_reference(policy_name, kw):
    jp, tp = j_get_policy(policy_name), get_policy(policy_name)
    rng = np.random.default_rng(0)
    Sq, Hq, Hkv, D = 48, 4, 2, 32
    dt = jp.compute_dtype
    q, k, v = (rng.standard_normal((B, Sq, h, D)).astype(np.float32).astype(dt)
               for h in (Hq, Hkv, Hkv))
    ct = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32).astype(dt)

    def j_fn(q, k, v):
        return JL.flash_attention(JQArith(jp), q, k, v, chunk=CHUNK, **kw)

    want, vjp = jax.vjp(j_fn, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(ct))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    got = TL.flash_attention(QArith(tp), tq, tk, tv, chunk=CHUNK, **kw)
    got.backward(_t(ct))
    tol = FLASH_TOL_F32 if policy_name == "fp32" else FLASH_TOL_BF16
    for name, a, b in [("out", got, want), ("dq", tq.grad, want_grads[0]),
                       ("dk", tk.grad, want_grads[1]), ("dv", tv.grad, want_grads[2])]:
        b = np.asarray(b, np.float32)
        assert a.dtype == tq.dtype and tuple(a.shape) == b.shape, name
        err = float(np.abs(_np(a) - b).max())
        assert err <= tol * float(np.abs(b).max()), (name, err)


def test_flash_attention_rejects_ragged_chunks():
    x = torch.zeros((1, 24, 2, 8))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TL.flash_attention(QArith(get_policy("fp32")), x, x, x, chunk=16)


# ---------------------------------------------------------------------------
# forward_logits, train step and trajectories against the reference
# ---------------------------------------------------------------------------

def _setup(policy_name):
    jp, tp = j_get_policy(policy_name), get_policy(policy_name)
    cfg = JR.get_config("qwen2.5-3b").reduced()
    params = JR.init(cfg, jax.random.PRNGKey(0), jp.param_dtype)
    return jp, tp, cfg, R.get_config("qwen2.5-3b").reduced(), params


def _batches(vocab, n, batch=B, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, size=(batch, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


@pytest.mark.parametrize("policy_name", ["fp32", "bf16_kahan"])
def test_forward_logits_match_reference(policy_name):
    jp, tp, cfg, tcfg, params = _setup(policy_name)
    batch = _batches(cfg.vocab, 1)[0]
    fwd = jax.jit(lambda p, b: JR.forward_logits(JQArith(jp), p, cfg, b, attn_chunk=CHUNK))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = fwd.lower(params, jb).compile(compiler_options=NO_EXCESS)(params, jb)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    with torch.no_grad():
        got = R.forward_logits(QArith(tp), tparams, tcfg,
                               {k: torch.from_numpy(v) for k, v in batch.items()},
                               attn_chunk=CHUNK)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, cfg.vocab)
    err = float(np.abs(_np(got) - np.asarray(want)).max())
    assert err <= STEP_TOL[policy_name]["logits"], err
    # remat changes nothing in the forward
    with torch.no_grad():
        again = R.forward_logits(QArith(tp), tparams, tcfg,
                                 {k: torch.from_numpy(v) for k, v in batch.items()},
                                 remat=False, attn_chunk=CHUNK)
    assert torch.equal(got, again)


@pytest.mark.parametrize("policy_name", ["fp32", "bf16_kahan"])
def test_train_steps_match_reference(policy_name):
    """Step 0's loss and grad_norm, then a 5-step loss trajectory."""
    jp, tp, cfg, tcfg, params = _setup(policy_name)
    lr = 2e-3
    jopt = j_adamw(jp, b2=0.997, weight_decay=0.01)
    jstate = j_make_train_state(params, jopt)
    tstate = from_jax_train_state(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    batches = _batches(cfg.vocab, 5)
    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jstep = jax.jit(j_make_train_step(cfg, jp, jopt, j_constant(lr), attn_chunk=CHUNK)).lower(
        jstate, jb0, 0).compile(compiler_options=NO_EXCESS)
    tstep = make_train_step(tcfg, tp, adamw(tp, b2=0.997, weight_decay=0.01), constant(lr),
                            attn_chunk=CHUNK)
    tol = STEP_TOL[policy_name]
    j_losses, t_losses = [], []
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, 0)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
        j_losses.append(float(jm["loss"]))
        t_losses.append(float(tm["loss"]))
        if i == 0:
            assert abs(t_losses[0] - j_losses[0]) <= tol["loss"] * j_losses[0]
            jn, tn = float(jm["grad_norm"]), float(tm["grad_norm"])
            assert abs(tn - jn) <= tol["grad_norm"] * jn, (tn, jn)
            assert tm["lr"] == pytest.approx(lr, rel=1e-7)
    assert tstate.step == 5
    np.testing.assert_allclose(t_losses, j_losses, rtol=tol["loss"])
    assert t_losses[-1] < t_losses[0]


def test_grad_accum_matches_one_big_batch():
    policy = get_policy("fp32")
    cfg = R.get_config("qwen2.5-3b").reduced()
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg.vocab, 1, batch=4)[0].items()}
    out = {}
    for k in (1, 2):
        params = R.init(cfg, 0, torch.float32, device="cpu")
        opt = adamw(policy)
        step = make_train_step(cfg, policy, opt, constant(1e-3), attn_chunk=CHUNK,
                               grad_accum=k)
        state, m = step(make_train_state(params, opt), batch, 0)
        out[k] = (float(m["loss"]), float(m["grad_norm"]), state.params)
    assert out[2][0] == pytest.approx(out[1][0], rel=1e-6)
    assert out[2][1] == pytest.approx(out[1][1], rel=1e-5)
    w1 = out[1][2]["layers"]["b0"]["ffn"]["w_up"]
    w2 = out[2][2]["layers"]["b0"]["ffn"]["w_up"]
    torch.testing.assert_close(w2, w1, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(cfg, policy, adamw(policy), constant(1e-3), grad_accum=3)(
            state, batch, 0)


def test_eval_step_and_dist_arguments():
    policy = get_policy("bf16_standard")
    cfg = R.get_config("qwen2.5-3b").reduced()
    params = R.init(cfg, 0, policy.param_dtype, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg.vocab, 1)[0].items()}
    m = make_eval_step(cfg, policy, attn_chunk=CHUNK)(params, batch)
    assert np.isfinite(float(m["loss"])) and 0.0 <= float(m["acc"]) <= 1.0
    # the dist arguments: a one-replica compressed wire trains, its residual
    # rows written in the update phase (bf12: the bf16 gradients lose bits);
    # replicated specs and the data-parallel placement are the default path;
    # an FSDP placement with its specs takes the reduce-scatter transport,
    # which on one process trains as the default path does
    opt = adamw(policy, b2=0.997)
    tr = make_transport(wire="bf12")
    state = make_train_state(params, opt, transport=tr)
    assert all(tuple(r.shape) == (1, *p.shape) for r, p in
               zip(tree_leaves(state.wire_residuals), tree_leaves(params)))
    gradients, update = make_train_step(cfg, policy, opt, constant(1e-3), transport=tr,
                                        attn_chunk=CHUNK).phases
    g = gradients(state, batch, 0)
    assert all(float(r.abs().sum()) == 0 for r in tree_leaves(state.wire_residuals))
    state, metrics = update(state, g, 0)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    assert any(float(r.abs().sum()) > 0 for r in tree_leaves(state.wire_residuals))
    mesh = make_local_mesh()
    step = make_train_step(cfg, policy, opt, constant(1e-3), attn_chunk=CHUNK,
                           pspecs=param_specs(params, cfg, mesh), placement=Placement())
    _, metrics = step(make_train_state(params, opt), batch, 0)
    assert np.isfinite(float(metrics["loss"]))
    fsdp = default_placement(mesh, fsdp=True)
    tr = make_transport(mesh=mesh, placement=fsdp, pspecs=param_specs(params, cfg, mesh,
                                                                      fsdp))
    assert (tr.name, fsdp.fsdp_axis, tr.scatter_axis) == ("reduce_scatter", "data", "data")
    fresh = R.init(cfg, 0, policy.param_dtype, device="cpu")
    step = make_train_step(cfg, policy, opt, constant(1e-3), attn_chunk=CHUNK, transport=tr)
    _, fsdp_metrics = step(make_train_state(fresh, opt), batch, 0)
    fresh = R.init(cfg, 0, policy.param_dtype, device="cpu")
    plain = make_train_step(cfg, policy, opt, constant(1e-3), attn_chunk=CHUNK)
    _, plain_metrics = plain(make_train_state(fresh, opt), batch, 0)
    assert float(fsdp_metrics["loss"]) == float(plain_metrics["loss"])


# ---------------------------------------------------------------------------
# the synthetic stream
# ---------------------------------------------------------------------------

def test_token_stream_grammar_matches_reference():
    vocab, batch, seq = 512, 3, 40
    jstream, tstream = JTokenStream(vocab, seed=5), TokenStream(vocab, seed=5)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jstream.batch(key, batch, seq))
    k1, _ = jax.random.split(key)
    u = np.asarray(jax.random.uniform(k1, (batch, seq + 1 + jstream.order)))
    np.testing.assert_array_equal(tstream.from_uniform(u), want)


def test_lm_batches_deterministic_and_resumable():
    def take(start, n, seed=0):
        it = lm_batches(512, 2, 16, seed=seed, start_step=start, device="cpu")
        return [next(it) for _ in range(n)]
    a, b = take(0, 5), take(0, 5)
    resumed = take(3, 2)
    for x, y in zip(a, b):
        assert torch.equal(x["tokens"], y["tokens"]) and torch.equal(x["labels"], y["labels"])
    for x, y in zip(a[3:], resumed):
        assert torch.equal(x["tokens"], y["tokens"])
    assert not torch.equal(a[0]["tokens"], a[1]["tokens"])
    assert not torch.equal(a[0]["tokens"], take(0, 1, seed=1)[0]["tokens"])
    first = a[0]
    assert first["tokens"].dtype == torch.int32 and tuple(first["tokens"].shape) == (2, 16)
    assert torch.equal(first["tokens"][:, 1:], first["labels"][:, :-1])
    assert int(first["tokens"].min()) >= 0 and int(first["tokens"].max()) < 512


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_on_the_cpu():
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2.5-3b",
           "--reduced", "--device", "cpu", "--steps", "30", "--batch", "4", "--seq", "32"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1].startswith("[train] done at step 30; final loss ")
    first = float(lines[1].split(" loss ")[1].split()[0])
    final = float(lines[-1].split("final loss ")[1].split(";")[0])
    assert np.isfinite(final) and final < first, (first, final)


def test_launcher_needs_a_card_or_the_cpu_flag():
    args = launch_train.parse_args(["--reduced", "--steps", "1"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.build(args)


@pytest.mark.parametrize("flags,slice_", [
    # ported with checkpointed training (slice_ None) and with the dist slice
    (["--ckpt-dir", "/nonexistent"], None),
    (["--spike-factor", "3"], None),
    (["--data-parallel", "2"], "dist"), (["--fsdp"], "dist"), (["--pods", "2"], "dist"),
    (["--grad-wire", "bf16"], "dist"), (["--wire-keep-fp32", "default"], "dist"),
    (["--process-id", "0"], "dist slice"),
])
def test_launcher_refuses_flags_of_later_slices(flags, slice_):
    """The dist slice's flags parse (a mesh that needs more processes than
    the run has raises when the run is built), FSDP's (A9) among them."""
    argv = ["--reduced", "--device", "cpu", *flags]
    if slice_ is None:
        cfg = launch_train.loop_config(launch_train.parse_args(argv))
        assert (cfg.ckpt_dir, cfg.spike_factor) in (("/nonexistent", None), (None, 3.0))
        return
    args = launch_train.parse_args(argv)
    value = getattr(args, flags[0][2:].replace("-", "_"))
    assert value == (True if len(flags) == 1 else type(value)(flags[1]))
    if args.data_parallel * args.pods > 1:
        with pytest.raises(ValueError, match="needs 2 processes"):
            launch_train.build(args)


@pytest.mark.parametrize("flags,item", [(["--model-parallel", "2"], "A11"),
                                        (["--fsdp-parallel", "2"], "A9"),
                                        (["--model-parallel", "2", "--fsdp"], "A13"),
                                        (["--model-parallel", "2", "--fsdp-parallel", "2"],
                                         "A13"),
                                        (["--model-parallel", "2", "--arch",
                                          "recurrentgemma-2b"], "A12")])
def test_launcher_refuses_the_later_dist_items(flags, item):
    """The model axis's ``--model-parallel`` (ported with A11; RG-LRU on it
    with A12) and FSDP's ``--fsdp-parallel`` (A9) parse, and a single
    process cannot build their 2-process mesh; FSDP beside a model axis
    (A13) is refused before any mesh."""
    argv = ["--reduced", "--device", "cpu", *flags]
    if item == "A13":
        with pytest.raises(ValueError, match=item):
            launch_train.parse_args(argv)
        return
    args = launch_train.parse_args(argv)
    assert (args.fsdp_parallel if item == "A9" else args.model_parallel) == 2
    with pytest.raises(ValueError, match="needs 2 processes"):
        launch_train.build(args)
