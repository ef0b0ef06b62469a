"""The port's paper harnesses and runner, on the CPU, at small sizes.

* ``train_tiny_lm`` 5 steps from the reference's f32 weights (converted)
  and the reference's token batches, with the reference's SR randomness
  (per-leaf bits under ``bf16_sr``, uniforms under ``fp16_sr``, handed in
  through ``GivenKey``), at Fig 12's settings (init scale 0.05, lr 1e-2):
  every step's loss within ``LM_TOL`` of the reference's step compiled
  without XLA:CPU's excess precision (f32 sums in another order and
  last-ulp differences of ``exp``/``rsqrt``/``silu`` can flip a 16-bit
  rounding somewhere in the 3-layer stack, as in tests/test_torch_train.py).
* ``train_dlrm`` under ``bf16_sr`` twice from one seed: the same losses,
  AUC and per-step work (the SR bits are Philox words of ``StepKey``).
* The runner lists the reference's fifteen sections in its order;
  ``--only fig10 --smoke --device cpu`` prints the reference's header and
  row name and exits 0; a section not ported yet fails, naming its
  ROADMAP item, while the other sections still run, and the run exits 1.
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

from benchmarks import run as j_run
from repro.core import get_policy as j_get_policy
from repro.data.synthetic import lm_batches as j_lm_batches
from repro.models import registry as JR
from repro.optim import adamw as j_adamw
from repro.optim import constant as j_constant
from repro.optim.base import init_params_for_policy as j_init_params_for_policy
from repro.train.step import make_train_step as j_make_train_step
from repro.train.train_state import make_train_state as j_make_train_state
from repro_torch.benchmarks import common as C
from repro_torch.benchmarks import run as runner
from repro_torch.convert import from_jax_params
from repro_torch.optim import GivenKey
from repro_torch.train import step as TS
from _torch_cpu import one_torch_thread, to_torch  # noqa: F401 (autouse fixture)


ROOT = Path(__file__).resolve().parent.parent
NO_EXCESS = {"xla_allow_excess_precision": False}
# measured: bf16_sr 4.0e-4, fp16_sr 2.1e-5 (the largest per-step |Δloss| of 5;
# step 0 equal bitwise under both)
LM_TOL = 2e-3
LM = dict(steps=5, seed=0, lr=1e-2, batch=4, seq=16, init_scale=0.05)


def _reference_noise(policy, key, params):
    """The reference's per-leaf SR randomness for ``key``: bits on the e8
    grids, uniforms for fp16, in leaf order."""
    leaves = jax.tree_util.tree_leaves(params)
    keys = jax.random.split(key, len(leaves))
    if policy.param_format.name == "fp16":
        return GivenKey([None] * len(leaves),
                        [to_torch(jax.random.uniform(k, w.shape, jnp.float32))
                         for k, w in zip(keys, leaves)])
    return GivenKey([to_torch(jax.random.bits(k, w.shape, jnp.uint32))
                     for k, w in zip(keys, leaves)])


@pytest.mark.parametrize("policy_name", ["bf16_sr", "fp16_sr"])
def test_train_tiny_lm_matches_reference(policy_name, monkeypatch):
    jp = j_get_policy(policy_name)
    cfg = JR.get_config("qwen2.5-3b").reduced()
    init = JR.init(cfg, jax.random.PRNGKey(LM["seed"]), jnp.float32)
    params = j_init_params_for_policy(
        jax.tree_util.tree_map(lambda w: w * LM["init_scale"], init), jp)
    opt = j_adamw(jp, b2=0.997)
    state = j_make_train_state(params, opt)
    batches = [b for _, b in zip(range(LM["steps"]), j_lm_batches(
        cfg.vocab, LM["batch"], LM["seq"], seed=LM["seed"]))]
    step = jax.jit(j_make_train_step(cfg, jp, opt, j_constant(LM["lr"]), attn_chunk=8)).lower(
        state, batches[0], LM["seed"]).compile(compiler_options=NO_EXCESS)
    want, noise = [], []
    for i, b in enumerate(batches):
        noise.append(_reference_noise(jp, jax.random.fold_in(
            jax.random.PRNGKey(LM["seed"]), i), state.params))
        state, m = step(state, b, LM["seed"])
        want.append(float(m["loss"]))

    def port_batches(vocab, batch, seq, *, seed, device):
        assert (vocab, batch, seq, seed) == (cfg.vocab, LM["batch"], LM["seq"], LM["seed"])
        for b in batches:
            yield {k: to_torch(v).to(device) for k, v in b.items()}

    monkeypatch.setattr(C, "lm_batches", port_batches)
    monkeypatch.setattr(TS, "StepKey", lambda seed, i: noise[i])
    losses, final, us = C.train_tiny_lm(
        policy_name, device="cpu", init_params=from_jax_params(
            jax.tree_util.tree_map(np.asarray, init), device="cpu"), **LM)
    assert len(losses) == LM["steps"] and us > 0
    assert final == pytest.approx(sum(losses) / 10)
    np.testing.assert_allclose(losses, want, rtol=0, atol=LM_TOL)
    assert losses[-1] < losses[0]


def test_train_dlrm_sr_is_deterministic():
    runs = [C.train_dlrm("bf16_sr", steps=12, device="cpu") for _ in range(2)]
    (l1, a1, f1, _), (l2, a2, f2, _) = runs
    assert l1 == l2 and a1 == a2 and f1 == f2 == []
    assert len(l1) == 12 and all(np.isfinite(l1))


def test_runner_lists_the_reference_sections():
    assert [name for name, _ in runner.SECTIONS] == [name for name, _ in j_run.SECTIONS]
    ported = [name for name, mod in runner.SECTIONS if not mod.startswith("ROADMAP")]
    assert ported == ["fig2_theory", "table3_bottleneck", "table4_accuracy",
                      "fig5_tradeoff", "fig9_cancellation", "fig10_sub16",
                      "fig11_combined", "fig12_fp16", "fsdp_memory", "grad_wire",
                      "grad_wire_sweep"]


def _run(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run", *args],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)


def test_runner_smoke_prints_the_reference_rows():
    out = _run("--only", "fig10", "--smoke", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [line.split(",")[0] for line in lines[1:]] == ["fig10_dlrm_bf12_sr"]
    auc, loss = (float(f.split("=")[1]) for f in lines[1].split(",")[2].split(";"))
    assert 0.0 <= auc <= 1.0 and np.isfinite(loss)


def test_runner_fails_loudly_on_a_section_not_ported(capsys):
    assert runner.main(["--only", "appB,fsdp,serve_batching", "--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert "appB_kernels is not ported yet (ROADMAP A6)" in out.err
    assert "serve_batching is not ported yet (ROADMAP A8)" in out.err
    # the sections after the first failure still ran; fsdp_memory (ported
    # with A9) prints its rows between the two failures
    assert "fsdp_memory" not in out.err.replace("section fsdp_memory took", "")
    assert [line.split(",")[0] for line in out.out.splitlines()] == [
        "name", "appB_kernels_ERROR", "fsdp_compare_dp_step", "fsdp_compare_fsdp_step",
        "fsdp_vs_dp_state_bytes_ratio", "serve_batching_ERROR"]


def test_runner_needs_a_card_or_the_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.main(["--only", "fig2"])
