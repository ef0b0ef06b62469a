"""Multi-process checkpoints, the loop's agreements, and the launcher, on
the CPU (the reference on one device in this process; the port's ranks
through ``repro_torch.launch.dist_launch``).

* Residual checkpoints cross the two packages both ways: the port's
  one-replica wire state restores into the reference's ``TrainState`` leaf
  for leaf; the reference's restores into the port's, its
  ``wire_format`` stamp honoured; a 2-rank checkpoint holds the
  reference's ``(2, *shape)`` stacks of the ranks' rows, which the
  reference restores and which give each rank its own row back.
* The four residual drift cases, each with the reference's log line: a
  checkpoint without residuals (the reference's legacy 3-field state),
  another replica count, another wire format (zero-init), and a stateless
  run (the stored residuals dropped unread).
* Two ranks agree on the restore step (process 0's LATEST, broadcast) and
  on SIGTERM (rank 1 alone is signalled; both stop at the same step, with
  one collective checkpoint).
* A fault injected into one rank's gradient phase ends both ranks with a
  nonzero exit within the group's timeout, not a hang.
* The launcher end to end: 2 ranks with the bf16 wire, checkpointing
  every 3 steps, end with ``[train] done at step 6`` from process 0 only;
  a 1-process resume logs the replica-count zero-init and ends at step 9.
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.dist import transport as JT
from repro.models import registry as JR
from repro.optim import adamw as j_adamw
from repro.optim import constant as j_constant
from repro.train import checkpoint as JC
from repro.train.step import make_train_step as j_make_train_step
from repro.train.train_state import make_train_state as j_make_train_state
from repro_torch.convert import from_jax_train_state, to_jax_wire_residuals
from repro_torch.core.policy import get_policy
from repro_torch.data.synthetic import lm_batches
from repro_torch.dist import fsdp as F
from repro_torch.dist import transport as T
from repro_torch.models import registry as R
from repro_torch.optim import adamw, constant
from repro_torch.train import checkpoint as C
from repro_torch.train.loop import TrainLoopConfig, _restore, run_training
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import make_train_state
from repro_torch.tree import tree_leaves

from _torch_cpu import one_torch_thread, to_torch  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(Path(__file__).resolve().parent / "_torch_dist_worker.py")
POLICY = "bf16_sr_kahan"
CFG = R.get_config("qwen2.5-3b").reduced()
TIMEOUT = 180


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    # one thread each: the ranks and the other test workers share the cores
    env["OMP_NUM_THREADS"] = "1"
    return env


def _port_run(wire="bf16", accum=2):
    """A one-replica compressed-wire run (grad_accum 2: f32 gradients, so
    the residuals are not zero)."""
    policy = get_policy(POLICY)
    opt = adamw(policy, b2=0.997)
    tr = T.make_transport(wire=wire)
    params = R.init(CFG, 0, policy.param_dtype, device="cpu")
    step = make_train_step(CFG, policy, opt, constant(1e-3), attn_chunk=8, transport=tr,
                           grad_accum=accum)
    return make_train_state(params, opt, transport=tr), step, tr


def _batches(s=0):
    return lm_batches(CFG.vocab, 4, 16, seed=3, start_step=s, device="cpu")


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _ref_state(wire=None, replicas=1):
    """The reference's state of the same structure (values to be restored)."""
    policy = j_get_policy(POLICY)
    opt = j_adamw(policy, b2=0.997)
    params = JR.init(JR.get_config("qwen2.5-3b").reduced(), jax.random.PRNGKey(0),
                     policy.param_dtype)
    state = j_make_train_state(params, opt)
    if wire is not None:
        state = state._replace(wire_residuals=jax.tree_util.tree_map(
            lambda w: jnp.zeros((replicas,) + w.shape, jnp.float32), params))
    return state, opt, policy


def test_port_residual_checkpoint_restores_in_the_reference(tmp_path):
    state, step, tr = _port_run()
    state, _ = run_training(state, step, _batches,
                            TrainLoopConfig(total_steps=2, ckpt_dir=str(tmp_path),
                                            ckpt_every=2, wire_format=tr.wire_format),
                            log=lambda *_: None, transport=tr)
    assert C.manifest(tmp_path)["extra"] == {"wire_format": "bf16"}
    like, _, _ = _ref_state("bf16")
    got, at = JC.restore(tmp_path, like)
    assert at == 2 and int(got.step) == 2
    ours = C.flatten(state)[1:]
    theirs = jax.tree_util.tree_leaves(got)[1:]
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))
    assert any(float(r.abs().max()) > 0 for r in tree_leaves(state.wire_residuals))


def test_reference_residual_checkpoint_restores_in_the_port(tmp_path):
    """The reference trains 2 steps through its one-replica bf16 wire
    (grad_accum 2) and saves with its stamp; the port's loop resumes it,
    residuals included, leaf for leaf."""
    jstate, jopt, jpolicy = _ref_state()
    jtr = JT.make_transport(wire="bf16")
    jstate = j_make_train_state(jstate.params, jopt, transport=jtr)
    jstep = jax.jit(j_make_train_step(JR.get_config("qwen2.5-3b").reduced(), jpolicy, jopt,
                                      j_constant(1e-3), attn_chunk=8, transport=jtr,
                                      grad_accum=2))
    for i, b in zip(range(2), _batches()):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v.numpy()) for k, v in b.items()}, 0)
    JC.save(tmp_path, 2, jstate, extra={"wire_format": jtr.wire_format})
    state, step, tr = _port_run()
    logs = []
    out, _ = run_training(state, step, _batches,
                          TrainLoopConfig(total_steps=2, ckpt_dir=str(tmp_path),
                                          wire_format=tr.wire_format),
                          log=logs.append, transport=tr)
    assert logs == ["[loop] resumed from checkpoint at step 2"]
    want = from_jax_train_state(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    for a, b in zip(C.flatten(out)[1:], C.flatten(want)[1:]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert any(float(r.abs().max()) > 0 for r in tree_leaves(out.wire_residuals))
    # a reference stack of 2 replicas gives each rank its row (through the
    # state's specs, as a multi-process run restores: this process stands
    # in for each rank of a 2-rank data mesh), and the rows go back to the
    # reference's stack
    stack = jax.tree_util.tree_map(
        lambda r: np.concatenate([np.asarray(r), 2 * np.asarray(r)]), jstate.wire_residuals)
    JC.save(tmp_path / "two", 2, jstate._replace(wire_residuals=stack),
            extra={"wire_format": "bf16"})
    rows = []
    for rank in range(2):
        st, _, _ = _port_run()
        mesh = SimpleNamespace(shape={"data": 2}, index=lambda axis, rank=rank: rank)
        mgr = C.CheckpointManager(tmp_path / "two", mesh=mesh)
        wire = SimpleNamespace(wire_replicas=2, replica=rank, wire_axis="data")
        st, _ = _restore(mgr, st, print, wire_format="bf16", transport=wire,
                         specs=F.train_state_specs(st, None, wire))
        rows.append(st.wire_residuals)
        ref_rows = from_jax_train_state(
            jax.tree_util.tree_map(np.asarray, jstate._replace(wire_residuals=stack)),
            device="cpu", replica=rank).wire_residuals
        for a, b in zip(tree_leaves(st.wire_residuals), tree_leaves(ref_rows)):
            assert torch.equal(a, b)
    back = to_jax_wire_residuals(rows)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(stack)):
        np.testing.assert_array_equal(a, b)


def _resume_logs(tmp_path, save_state, *, extra=None, wire="bf16"):
    C.save(tmp_path, 1, save_state, extra=extra)
    state, step, tr = _port_run(wire) if wire else _stateless()
    logs = []
    if wire:
        with torch.no_grad():
            for r in tree_leaves(state.wire_residuals):
                r.fill_(5.0)        # stale values the restore must zero
    out, _ = run_training(state, step, _batches,
                          TrainLoopConfig(total_steps=1, ckpt_dir=str(tmp_path),
                                          wire_format=getattr(tr, "wire_format", None)),
                          log=logs.append, transport=tr)
    return out, logs


def _stateless():
    policy = get_policy(POLICY)
    opt = adamw(policy, b2=0.997)
    tr = T.make_transport()
    params = R.init(CFG, 0, policy.param_dtype, device="cpu")
    return (make_train_state(params, opt, transport=tr),
            make_train_step(CFG, policy, opt, constant(1e-3), attn_chunk=8, transport=tr), tr)


def _zero(tree):
    return all(float(r.abs().max()) == 0 for r in tree_leaves(tree))


def _rows(params, n, value):
    return {k: _rows(v, n, value) if isinstance(v, dict) else
            torch.full((n, *v.shape), value) for k, v in params.items()}


@pytest.mark.parametrize("case", ["legacy", "replicas", "format", "stateless"])
def test_residual_drift_cases(tmp_path, case):
    base, _, _ = _port_run()
    base = base._replace(step=1)
    if case == "legacy":
        # the reference's state without residuals: its legacy 3-field layout
        jstate, _, _ = _ref_state()
        JC.save(tmp_path, 1, jstate._replace(step=jnp.int32(1)))
        state, step, tr = _port_run()
        logs = []
        out, _ = run_training(state, step, _batches,
                              TrainLoopConfig(total_steps=1, ckpt_dir=str(tmp_path),
                                              wire_format="bf16"),
                              log=logs.append, transport=tr)
        line = "[loop] checkpoint has no wire_residuals; zero-initialized error-feedback buffers"
        assert out.step == 1 and _zero(out.wire_residuals)
    elif case == "replicas":
        out, logs = _resume_logs(tmp_path, base._replace(
            wire_residuals=_rows(base.params, 2, 1.0)), extra={"wire_format": "bf16"})
        line = ("[loop] wire replica count changed since checkpoint; "
                "zero-initialized error-feedback buffers")
        assert _zero(out.wire_residuals)
    elif case == "format":
        out, logs = _resume_logs(tmp_path, base._replace(
            wire_residuals=_rows(base.params, 1, 1.0)), extra={"wire_format": "bf16"},
            wire="bf12")
        line = ("[loop] gradient-wire format changed since checkpoint (bf16 -> bf12); "
                "zero-initialized error-feedback buffers")
        assert _zero(out.wire_residuals)
    else:
        out, logs = _resume_logs(tmp_path, base._replace(
            wire_residuals=_rows(base.params, 1, 1.0)), extra={"wire_format": "bf16"},
            wire=None)
        line = "[loop] dropping checkpointed wire_residuals (stateless gradient transport)"
        assert out.wire_residuals is None
    assert line in logs and "[loop] resumed from checkpoint at step 1" in logs
    # everything but the residuals restored
    for a, b in zip(C.flatten(out._replace(wire_residuals=None))[1:],
                    C.flatten(base._replace(wire_residuals=None))[1:]):
        if case != "legacy":
            assert torch.equal(a, b)


def _launch(args, out, n=2, log_dir=None):
    cmd = [sys.executable, "-m", "repro_torch.launch.dist_launch", "-n", str(n),
           "--timeout", str(TIMEOUT - 20)]
    if log_dir is not None:
        cmd += ["--log-dir", str(log_dir)]
    return subprocess.run(cmd + ["--", sys.executable, *args], capture_output=True, text=True,
                          timeout=TIMEOUT, env=_env(), cwd=ROOT)


def test_ranks_agree_on_restore_step_and_sigterm(tmp_path):
    run = _launch([WORKER, "agree", str(tmp_path)], tmp_path)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    a, b = (torch.load(tmp_path / f"rank{r}_agree.pt") for r in range(2))
    assert a["agreed"] == b["agreed"] == 3          # process 0's LATEST, not rank 1's 1
    assert a["preempted"] and b["preempted"] and a["step"] == b["step"] == 3
    assert "[loop] preempted at step 2; checkpointed and exiting" in a["logs"]
    assert C.latest_step(tmp_path / "ck") == 3
    man = C.manifest(tmp_path / "ck")
    assert man["extra"] == {"wire_format": "bf16"}
    # the residual rows of both ranks, stacked in rank order
    n_params = len(tree_leaves(R.init(CFG, 0, torch.bfloat16, device="cpu")))
    assert all(s[0] == 2 for s in man["shapes"][-n_params:])


def test_fault_on_one_rank_fails_both(tmp_path):
    """Rank 1's gradient phase fails on every attempt: it raises (no crash
    save under multi-process); rank 0, waiting in the wire's collective,
    fails too instead of hanging."""
    procs = __import__("repro_torch.launch.dist_launch", fromlist=["launch"]).launch(
        [sys.executable, WORKER, "fault", str(tmp_path)], 2, env=_env(), log_dir=tmp_path)
    try:
        codes = [p.wait(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes[0] != 0 and codes[1] != 0, codes
    log1 = (tmp_path / "rank1_fault.log").read_text()
    assert "raising for a restart from the last committed checkpoint" in log1
    assert "injected fault" in (tmp_path / "rank1.log").read_text()


def test_launcher_two_ranks_then_one_process_resume(tmp_path):
    ck = tmp_path / "ck"
    argv = ["-m", "repro_torch.launch.train", "--arch", "qwen2.5-3b", "--reduced",
            "--device", "cpu", "--batch", "4", "--seq", "16", "--grad-wire", "bf16",
            "--ckpt-every", "3", "--ckpt-dir", str(ck), "--grad-accum", "2"]
    run = _launch([*argv, "--data-parallel", "2", "--steps", "6"], tmp_path,
                  log_dir=tmp_path / "logs")
    assert run.returncode == 0, run.stderr[-4000:]
    rank0 = (tmp_path / "logs" / "rank0.log").read_text().splitlines()
    rank1 = (tmp_path / "logs" / "rank1.log").read_text()
    assert [l for l in rank0 if l.startswith("[train] done")][0].startswith(
        "[train] done at step 6; final loss ")
    assert "[train]" not in rank1 and "[loop]" not in rank1
    man = json.loads((ck / "step_000000006" / "manifest.json").read_text())
    assert man["extra"] == {"wire_format": "bf16"} and man["shapes"][-1][0] == 2
    resume = subprocess.run([sys.executable, *argv, "--steps", "9"], capture_output=True,
                            text=True, timeout=TIMEOUT, env=_env(), cwd=ROOT)
    assert resume.returncode == 0, resume.stderr[-4000:]
    out = resume.stdout.splitlines()
    assert ("[loop] wire replica count changed since checkpoint; "
            "zero-initialized error-feedback buffers") in out
    assert "[loop] resumed from checkpoint at step 6" in out
    assert out[-1].startswith("[train] done at step 9; final loss ")
