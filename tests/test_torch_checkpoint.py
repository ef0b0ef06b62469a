"""The port's checkpoints on the CPU: the single-process cases of the
reference's tests/test_checkpoint.py, plus what the port adds.

* Layout and atomic commit: ``step_XXXXXXXXX/{manifest.json, arrays.npz}``
  and LATEST; tmp dirs are never taken for checkpoints; stale ones are
  removed, recent or in-flight ones never; a missing or dangling LATEST
  falls back to the newest valid step and is repaired; keep-N never
  removes the LATEST target.
* Round trips: bitwise for every dtype, bf16 included (its raw bits, NaN
  payloads and signed zeros too); a different dtype in ``like`` casts;
  structure and shape mismatches are refused.
* Async: commits land in submission order, a background failure is
  re-raised at ``drain``, and the snapshot owns its bytes — the state is
  updated in place right after ``maybe_save`` and the committed arrays
  are still the snapshot's.
* Interop, both directions: a reference ``TrainState`` saved by
  ``repro.train.checkpoint.save`` after 2 steps restores in the port
  bitwise equal to ``convert.from_jax_train_state`` of it, and a port
  checkpoint restores through ``repro.train.checkpoint.restore`` with
  equal leaves.
"""
import json
import os
import shutil
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.data.synthetic import lm_batches as j_lm_batches
from repro.models import registry as JR
from repro.optim import adamw as j_adamw
from repro.optim import constant as j_constant
from repro.train import checkpoint as JC
from repro.train.step import make_train_step as j_make_train_step
from repro.train.train_state import make_train_state as j_make_train_state
from repro_torch.convert import from_jax_train_state
from repro_torch.core.policy import get_policy
from repro_torch.models import registry as R
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as C
from repro_torch.train.train_state import make_train_state
from _torch_cpu import one_torch_thread  # noqa: F401


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((16, 8), generator=g).to(torch.bfloat16),
            "opt": {"m": torch.randn((16, 8), generator=g),
                    "step": torch.tensor(7 + seed, dtype=torch.int32)}}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _assert_equal(a, b):
    for x, y in zip(C.flatten(a), C.flatten(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _age(path, secs=2 * C.TMP_STALE_SECS):
    t = time.time() - secs
    os.utime(path, (t, t))


def test_layout_and_atomic_commit(tmp_path):
    final = C.save(tmp_path, 5, _tree())
    assert final == tmp_path / "step_000000005"
    assert sorted(p.name for p in final.iterdir()) == ["arrays.npz", "manifest.json"]
    assert (tmp_path / "LATEST").read_text() == "step_000000005"
    assert not list(tmp_path.glob("tmp.*")) and not list(tmp_path.glob(".latest.*"))
    man = json.loads((final / "manifest.json").read_text())
    assert man["step"] == 5 and man["n_leaves"] == 3
    # leaves in the reference's order (sorted keys: opt.m, opt.step, w),
    # bf16 as raw uint16
    assert man["dtypes"] == ["float32", "int32", "bfloat16"]
    assert man["shapes"] == [[16, 8], [], [16, 8]]
    with np.load(final / "arrays.npz") as data:
        assert sorted(data.files) == ["a0", "a1", "a2"] and data["a2"].dtype == np.uint16


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16, torch.int32])
def test_roundtrip_bitwise(tmp_path, dtype):
    if dtype == torch.bfloat16:
        # every bf16 bit pattern: NaN payloads, infinities, signed zeros
        w = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16).view(dtype)
    else:
        w = (torch.randn(257, generator=torch.Generator().manual_seed(1)) * 100).to(dtype)
    tree = {"w": w, "n": torch.tensor(3, dtype=torch.int32)}
    C.save(tmp_path, 2, tree)
    got, step = C.restore(tmp_path, _zeros_like(tree))
    assert step == 2
    assert torch.equal(got["w"].view(torch.int16 if dtype == torch.bfloat16 else dtype),
                       w.view(torch.int16 if dtype == torch.bfloat16 else dtype))
    assert got["w"].dtype == dtype and int(got["n"]) == 3


def test_restore_writes_into_like_in_place(tmp_path):
    C.save(tmp_path, 1, _tree(1))
    like = _zeros_like(_tree())
    ptrs = [t.data_ptr() for t in C.flatten(like)]
    got, _ = C.restore(tmp_path, like)
    assert [t.data_ptr() for t in C.flatten(got)] == ptrs
    _assert_equal(got, _tree(1))


def test_mixed_dtype_roundtrip_casts_to_like(tmp_path):
    t = {"w": torch.linspace(-2, 2, 32).reshape(8, 4),
         "m": torch.linspace(0, 1, 8).to(torch.bfloat16),
         "step": torch.tensor(3, dtype=torch.int32)}
    C.save(tmp_path, 1, t)
    like = {"w": torch.zeros((8, 4), dtype=torch.bfloat16),
            "m": torch.zeros(8), "step": torch.tensor(0, dtype=torch.int32)}
    got, _ = C.restore(tmp_path, like)
    assert torch.equal(got["w"], t["w"].to(torch.bfloat16))
    assert torch.equal(got["m"], t["m"].float()) and int(got["step"]) == 3


@pytest.mark.parametrize("bad", ["structure", "shape"])
def test_mismatch_rejected(tmp_path, bad):
    C.save(tmp_path, 1, _tree())
    like = _tree()
    if bad == "structure":
        like = {"w": like["w"]}
    else:
        like["w"] = torch.zeros((4, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        C.restore(tmp_path, like)


def test_latest_pointer_and_keep_n(tmp_path):
    for s in range(6):
        C.save(tmp_path, s, _tree(s), keep_n=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_000000004",
                                                               "step_000000005"]
    assert C.latest_step(tmp_path) == 5
    _assert_equal(C.restore(tmp_path, _zeros_like(_tree()))[0], _tree(5))
    # GC never removes the LATEST target, even when it is the oldest
    (tmp_path / "LATEST").write_text("step_000000004")
    C._gc(tmp_path, 1)
    assert (tmp_path / "step_000000004").exists()


def test_tmp_dirs_invisible_and_gc(tmp_path):
    C.save(tmp_path, 1, _tree())
    stale, fresh, mine = (tmp_path / f"tmp.{n}" for n in ("2.dead", "9.aaaa", "7.cccc"))
    for d in (stale, fresh, mine):
        d.mkdir()
        (d / "arrays.npz").write_bytes(b"garbage")
    _age(stale)
    _age(mine)
    assert C.latest_step(tmp_path) == 1
    C._IN_FLIGHT.add(str(mine))
    try:
        C.save(tmp_path, 3, _tree())
    finally:
        C._IN_FLIGHT.discard(str(mine))
    assert not stale.exists()          # a crashed writer's
    assert fresh.exists()              # may be a writer in flight
    assert mine.exists()               # a live writer of this process owns it


@pytest.mark.parametrize("damage", ["dangling", "missing", "rmtree"])
def test_latest_repair(tmp_path, damage):
    C.save(tmp_path, 1, _tree(1))
    C.save(tmp_path, 2, _tree(2))
    want = 2
    if damage == "dangling":
        (tmp_path / "LATEST").write_text("step_000009999")
    elif damage == "missing":
        (tmp_path / "LATEST").unlink()
    else:       # a crash between rmtree(final) and the rename of an overwrite
        shutil.rmtree(tmp_path / "step_000000002")
        want = 1
    assert C.latest_step(tmp_path) == want
    assert (tmp_path / "LATEST").read_text().strip() == f"step_{want:09d}"
    _assert_equal(C.restore(tmp_path, _zeros_like(_tree()))[0], _tree(want))


def test_no_valid_checkpoint_is_none(tmp_path):
    (tmp_path / "LATEST").write_text("step_000000042")
    (tmp_path / "step_000000042").mkdir()                 # no manifest
    assert C.latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        C.restore(tmp_path, _tree())


def test_manager_cadence_force_and_explicit_step(tmp_path):
    mgr = C.CheckpointManager(tmp_path, every_steps=10, keep_n=5)
    assert [s for s in range(35) if mgr.maybe_save(s, _tree(s))] == [10, 20, 30]
    assert mgr.maybe_save(33, _tree(33), force=True) is not None
    got, step = mgr.restore_latest(_zeros_like(_tree()), step=20)
    assert step == 20
    _assert_equal(got, _tree(20))
    assert mgr.restore_latest(_zeros_like(_tree()))[1] == 33


def test_async_commits_in_submission_order(tmp_path, monkeypatch):
    """The writer thread and the saving thread under a short switch
    interval: commits land in order, keep-N holds, LATEST is the last."""
    committed = []
    real = C._commit

    def slow_commit(directory, snap, keep_n):
        time.sleep(0.02 if snap.step % 2 == 0 else 0.0)
        committed.append(snap.step)
        return real(directory, snap, keep_n)

    monkeypatch.setattr(C, "_commit", slow_commit)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with C.CheckpointManager(tmp_path, every_steps=1, keep_n=3, async_saves=True,
                                 max_pending=2) as mgr:
            for s in range(1, 21):
                mgr.maybe_save(s, _tree(s))
            assert mgr.has_checkpoint()                  # drains first
            got, step = mgr.restore_latest(_zeros_like(_tree()))
            thread = mgr._async._thread
    finally:
        sys.setswitchinterval(interval)
    thread.join(timeout=30)
    assert not thread.is_alive()                        # closed by the manager
    assert committed == list(range(1, 21)) and step == 20
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        f"step_{s:09d}" for s in (18, 19, 20)]
    _assert_equal(got, _tree(20))


def test_snapshot_owns_its_bytes(tmp_path, monkeypatch):
    """The state is updated in place right after ``maybe_save`` (as the
    optimizers do); the committed arrays are the snapshot's."""
    gate = []
    real = C._commit

    def held_commit(directory, snap, keep_n):
        while not gate:                       # commit only after the mutation
            time.sleep(0.01)
        return real(directory, snap, keep_n)

    monkeypatch.setattr(C, "_commit", held_commit)
    state = _tree(3)
    want = [t.clone() for t in C.flatten(state)]
    with C.CheckpointManager(tmp_path, every_steps=1, async_saves=True) as mgr:
        mgr.maybe_save(1, state)
        with torch.no_grad():
            for t in C.flatten(state):
                t.add_(1)
        gate.append(True)
        mgr.drain()
    with np.load(tmp_path / "step_000000001" / "arrays.npz") as data:
        for i, t in enumerate(want):
            raw = t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
                else t.numpy()
            assert np.array_equal(data[f"a{i}"], raw), i


def test_async_drain_reraises_a_failure(tmp_path, monkeypatch):
    def boom(directory, snap, keep_n):
        raise OSError("disk full")

    monkeypatch.setattr(C, "_commit", boom)
    mgr = C.CheckpointManager(tmp_path, every_steps=1, async_saves=True)
    mgr.maybe_save(1, _tree())
    with pytest.raises(RuntimeError, match="async checkpoint"):
        mgr.drain()
    mgr.drain()                              # reported once


@pytest.fixture(scope="module")
def jax_state():
    """A reference ``TrainState`` after 2 steps of bf16_sr_kahan AdamW."""
    policy = j_get_policy("bf16_sr_kahan")
    cfg = JR.get_config("qwen2.5-3b").reduced()
    params = JR.init(cfg, jax.random.PRNGKey(0), policy.param_dtype)
    opt = j_adamw(policy, b2=0.997)
    state = j_make_train_state(params, opt)
    step = jax.jit(j_make_train_step(cfg, policy, opt, j_constant(1e-3), attn_chunk=8))
    stream = j_lm_batches(cfg.vocab, 2, 16, seed=4)
    for _ in range(2):
        state, _ = step(state, next(stream), 0)
    return state


def _port_state():
    policy = get_policy("bf16_sr_kahan")
    params = R.init(R.get_config("qwen2.5-3b").reduced(), 1, policy.param_dtype, device="cpu")
    return make_train_state(params, adamw(policy, b2=0.997))


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def test_reference_checkpoint_restores_in_the_port(tmp_path, jax_state):
    JC.save(tmp_path, 2, jax_state)
    want = from_jax_train_state(jax.tree_util.tree_map(np.asarray, jax_state), device="cpu")
    got, step = C.restore(tmp_path, _port_state())
    assert step == 2 and got.step == 2 and want.step == 2
    leaves, ref = C.flatten(got)[1:], C.flatten(want)[1:]
    assert len(leaves) == len(ref) == len(jax.tree_util.tree_leaves(jax_state)) - 1
    for a, b in zip(leaves, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_checkpoint_restores_in_the_reference(tmp_path, jax_state):
    state = from_jax_train_state(jax.tree_util.tree_map(np.asarray, jax_state), device="cpu")
    C.save(tmp_path, 2, state)
    like = jax.tree_util.tree_map(jnp.zeros_like, jax_state)
    got, step = JC.restore(tmp_path, like)
    assert step == 2 and int(got.step) == 2
    for a, b in zip(jax.tree_util.tree_leaves(got)[1:], C.flatten(state)[1:]):
        a, b = np.asarray(a).reshape(-1), _np(b).reshape(-1)
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))
