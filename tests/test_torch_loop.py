"""The port's fault-tolerant training loop on the CPU (ported from the
reference's tests/test_loop.py, single process).

* Resume is exact: 6 straight steps ≡ 3 steps + checkpoint + restore into
  a fresh state + 3 steps, bitwise on every leaf, with fused and non-fused
  AdamW under ``bf16_sr_kahan``; the batch stream is requested at the
  restored step, never replayed.
* The retry: a transient fault of the gradient phase is retried and the
  run equals one without the fault, bitwise; a persistent one checkpoints
  the pre-step state (equal to the uninterrupted run's state there) and
  raises; a fault once the update has begun is neither retried nor
  checkpointed (the state is torn).
* The spike monitor rolls back and widens the cadence; rows of a
  discarded trajectory never reach history, rows of a cleared suspicion
  merge back in order; it requires ``ckpt_dir`` and callable batches.
* SIGTERM with async saves checkpoints and returns ``preempted``.
* A checkpoint that carries gradient-wire residuals, resumed by a run
  with no gradient wire, drops them unread with the reference's log line
  and restores the rest (the drift cases of a compressed wire are in
  tests/test_torch_dist_ckpt.py).
* ``python -m repro_torch.launch.train --device cpu --ckpt-dir`` resumes
  and prints the resume line.
"""
import dataclasses
import itertools
import os
import signal

import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from repro_torch.core.policy import get_policy
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch import train as launch_train
from repro_torch.models import registry as R
from repro_torch.optim import adamw, constant, fused_adamw_optimizer
from repro_torch.train import checkpoint as C
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import TrainState, make_train_state

POLICY = get_policy("bf16_sr_kahan")
CFG = R.get_config("qwen2.5-3b").reduced()
QUIET = dict(log=lambda *_: None)


def _setup(fused=False):
    params = R.init(CFG, 0, POLICY.param_dtype, device="cpu")
    opt = (fused_adamw_optimizer if fused else adamw)(POLICY, b2=0.997)
    state = make_train_state(params, opt)
    return state, make_train_step(CFG, POLICY, opt, constant(1e-3), attn_chunk=8), opt


def _batches(start_step=0):
    return lm_batches(CFG.vocab, 2, 16, seed=9, start_step=start_step, device="cpu")


def _assert_same_state(a: TrainState, b: TrainState):
    assert a.step == b.step
    la, lb = C.flatten(a)[1:], C.flatten(b)[1:]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _straight(steps, fused=False):
    state, step, _ = _setup(fused)
    return run_training(state, step, _batches, TrainLoopConfig(total_steps=steps), **QUIET)


@pytest.mark.parametrize("fused", [False, True], ids=["adamw", "fused_adamw"])
def test_resume_is_exact(tmp_path, fused):
    full, info = _straight(6, fused)
    state, step, _ = _setup(fused)
    half, _ = run_training(state, step, _batches,
                           TrainLoopConfig(total_steps=3, ckpt_dir=str(tmp_path), ckpt_every=3),
                           **QUIET)
    assert C.latest_step(tmp_path) == 3
    logs = []
    fresh, step, _ = _setup(fused)
    resumed, rinfo = run_training(fresh, step, _batches,
                                  TrainLoopConfig(total_steps=6, ckpt_dir=str(tmp_path),
                                                  ckpt_every=1000), log=logs.append)
    assert "[loop] resumed from checkpoint at step 3" in logs
    _assert_same_state(resumed, full)
    assert [r["loss"] for r in rinfo["history"]] == [r["loss"] for r in info["history"][3:]]


def test_resume_does_not_replay_batch_stream(tmp_path):
    starts, consumed = [], []

    def factory(start_step):
        starts.append(start_step)

        def gen():
            b = _batches(start_step)
            for i in itertools.count(start_step):
                consumed.append(i)
                yield next(b)
        return gen()

    for total in (3, 6):
        state, step, _ = _setup()
        run_training(state, step, factory,
                     TrainLoopConfig(total_steps=total, ckpt_dir=str(tmp_path), ckpt_every=3),
                     **QUIET)
    assert starts == [0, 3]
    assert consumed == list(range(6))


def test_transient_gradient_fault_is_retried_exactly():
    full, _ = _straight(4)
    boom = {"count": 0}

    def fault_hook(s):
        if s == 2 and boom["count"] < 2:
            boom["count"] += 1
            raise RuntimeError("injected transient failure")

    state, step, _ = _setup()
    logs = []
    got, _ = run_training(state, step, _batches, TrainLoopConfig(total_steps=4),
                          log=logs.append, fault_hook=fault_hook)
    assert boom["count"] == 2
    assert sum("retry" in line for line in logs) == 2
    _assert_same_state(got, full)


def test_persistent_gradient_fault_saves_the_pre_step_state(tmp_path):
    want, _ = _straight(2)

    def always_fail(s):
        if s == 2:
            raise RuntimeError("permanent")

    state, step, _ = _setup()
    with pytest.raises(RuntimeError, match="permanent"):
        run_training(state, step, _batches,
                     TrainLoopConfig(total_steps=6, ckpt_dir=str(tmp_path), ckpt_every=100,
                                     max_retries_per_step=1), fault_hook=always_fail, **QUIET)
    assert C.latest_step(tmp_path) == 2
    fresh, _, _ = _setup()
    _assert_same_state(C.restore(tmp_path, fresh)[0], want)


def test_update_phase_fault_is_not_retried_or_saved(tmp_path):
    state, _, opt = _setup()
    calls = []

    def tearing_update(grads, opt_state, params, **kw):
        calls.append(kw["step"])
        if kw["step"] == 3:
            with torch.no_grad():
                params["embed"]["embedding"].add_(1.0)    # part of the write
            raise RuntimeError("fault inside the update")
        return opt.update(grads, opt_state, params, **kw)

    step = make_train_step(CFG, POLICY, dataclasses.replace(opt, update=tearing_update),
                           constant(1e-3), attn_chunk=8)
    logs = []
    with pytest.raises(RuntimeError, match="inside the update"):
        run_training(state, step, _batches,
                     TrainLoopConfig(total_steps=6, ckpt_dir=str(tmp_path), ckpt_every=2),
                     log=logs.append)
    assert calls == [0, 1, 2, 3]                   # step 3's update ran once
    assert C.latest_step(tmp_path) == 2            # the cadence save, no crash save
    assert any("update phase" in line and "torn" in line for line in logs)


def _fake_step(rolled, spikes=(7, 8)):
    def step_fn(state, batch, seed):
        s = int(state.step)
        loss = 1.0 + 0.001 * s
        if s in spikes and not rolled["done"]:
            loss = 1e9
        return state._replace(step=state.step + 1), {"loss": torch.tensor(loss)}
    return step_fn


def _fake_state():
    return TrainState(0, {"w": torch.zeros(4)}, {}, None)


def test_spike_rollback_restores_and_widens_cadence(tmp_path):
    rolled = {"done": False}
    starts = []

    def factory(start_step):
        starts.append(start_step)
        if start_step > 0:
            rolled["done"] = True
        return itertools.repeat({})

    logs = []
    out, info = run_training(
        _fake_state(), _fake_step(rolled), factory,
        TrainLoopConfig(total_steps=12, ckpt_dir=str(tmp_path), ckpt_every=2,
                        spike_factor=4.0, spike_patience=2, log_every=100),
        log=logs.append)
    assert info["rollbacks"] == 1 and out.step == 12
    assert starts[0] == 0 and len(starts) == 2 and 0 < starts[1] <= 8
    assert any("rolled back to step" in line for line in logs), logs
    assert any("ckpt_every -> 4" in line for line in logs), logs
    assert all(m["loss"] < 10.0 for m in info["history"][-4:])


def test_spike_suspect_rows_never_reach_history(tmp_path):
    rolled = {"done": False}

    def factory(start_step):
        if start_step > 0:
            rolled["done"] = True
        return itertools.repeat({})

    _, info = run_training(
        _fake_state(), _fake_step(rolled), factory,
        TrainLoopConfig(total_steps=12, ckpt_dir=str(tmp_path), ckpt_every=2,
                        spike_factor=4.0, spike_patience=2, log_every=3), **QUIET)
    assert info["rollbacks"] == 1
    assert all(m["loss"] < 1e6 for m in info["history"]), info["history"]
    assert len(info["history"]) == 13          # 0..6 once, 6..11 again after the rollback


def test_spike_under_patience_rows_merge_back(tmp_path):
    _, info = run_training(
        _fake_state(), _fake_step({"done": False}, spikes=(5, 9)),
        lambda s: itertools.repeat({}),
        TrainLoopConfig(total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=3,
                        spike_factor=4.0, spike_patience=2, log_every=100), **QUIET)
    assert info["rollbacks"] == 0 and len(info["history"]) == 10
    assert [i for i, m in enumerate(info["history"]) if m["loss"] >= 1e6] == [5, 9]


@pytest.mark.parametrize("missing", ["ckpt_dir", "callable batches"])
def test_spike_monitor_requirements(tmp_path, missing):
    kw = dict(total_steps=1, spike_factor=3.0)
    batches = lambda s: iter([])                   # noqa: E731
    if missing == "callable batches":
        kw["ckpt_dir"] = str(tmp_path)
        batches = iter([])
    with pytest.raises(ValueError, match=missing):
        run_training(_fake_state(), _fake_step({"done": True}), batches,
                     TrainLoopConfig(**kw), **QUIET)


def test_sigterm_preemption_checkpoints_with_async_saves(tmp_path, monkeypatch):
    state, step, _ = _setup()

    def fault_hook(s):
        if s == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    commits = []
    real = C._commit

    def counting(directory, snap, keep_n):
        commits.append(snap.step)
        return real(directory, snap, keep_n)

    monkeypatch.setattr(C, "_commit", counting)
    state, info = run_training(
        state, step, _batches,
        TrainLoopConfig(total_steps=50, ckpt_dir=str(tmp_path), ckpt_every=2,
                        async_saves=True), fault_hook=fault_hook, **QUIET)
    assert info["preempted"] and state.step == 4
    assert C.latest_step(tmp_path) == 4            # step 3 ran, then the exit
    assert commits == [2, 4]                       # step 4 committed once


def test_checkpoint_with_wire_residuals_is_refused(tmp_path):
    """A stateless run refuses the residuals, not the checkpoint: it drops
    them unread, logs the reference's line and restores everything else."""
    state, step, _ = _setup()
    state = state._replace(step=1)
    C.save(tmp_path, 1, state._replace(wire_residuals=_expand(state.params, 2.0)))
    fresh, _, _ = _setup()
    logs = []
    out, _ = run_training(fresh, step, _batches,
                          TrainLoopConfig(total_steps=1, ckpt_dir=str(tmp_path)),
                          log=logs.append)
    assert "[loop] dropping checkpointed wire_residuals (stateless gradient transport)" in logs
    assert "[loop] resumed from checkpoint at step 1" in logs
    assert out.wire_residuals is None and out.step == 1
    _assert_same_state(out, state)


def _expand(tree, value=0.0):
    """A (1, *shape) buffer per leaf: one wire replica's residuals."""
    if isinstance(tree, dict):
        return {k: _expand(v, value) for k, v in tree.items()}
    return torch.full((1, *tree.shape), value, dtype=torch.float32)


def test_launcher_resumes_on_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    launch_train.main([*argv, "--steps", "2", "--sync-ckpt"])
    assert C.latest_step(tmp_path) == 2
    launch_train.main([*argv, "--steps", "4", "--spike-factor", "100"])
    out = capsys.readouterr().out.splitlines()
    assert "[loop] resumed from checkpoint at step 2" in out
    assert out[-1].startswith("[train] done at step 4; final loss ")
    assert C.latest_step(tmp_path) == 4
