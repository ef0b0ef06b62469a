"""FSDP checkpoints on the CPU: resume, elastic restores in both packages'
formats, and the stateless transport's single writer (2 gloo ranks).

* An FSDP-2 run through the one-replica bf16 wire (``grad_accum`` 2, so
  its residual shards move), rank 1 alone SIGTERMed at step 1: both stop
  at step 2 with a checkpoint, and a fresh state resumes from it to step 4
  bitwise equal to the uninterrupted run on every shard of params, m, v,
  c and the residual rows, loss for loss.
* The checkpoint holds full leaves (the reference's layout; residual
  stacks ``(1, *shape)``): it restores under DP-2 and in one process to
  the same full leaves, and the reference's ``restore`` reads it to the
  same values. A DP-2 checkpoint and the reference's own restore under
  FSDP-2, each rank receiving its shard of every stored leaf; so does
  ``convert.from_jax_train_state(specs=, mesh=)`` of a reference state.
* With a stateless transport (fp32 DP-2) only process 0 commits
  checkpoints: every rank committed before (a fault of PR 22's loop, which
  gathered only the wire's residual rows collectively).
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.models import registry as JR
from repro.optim import adamw as j_adamw
from repro.train import checkpoint as JC
from repro.train.train_state import make_train_state as j_make_train_state
from repro_torch.convert import from_jax_train_state
from repro_torch.core.policy import get_policy
from repro_torch.dist import fsdp as F
from repro_torch.dist import partition as PT
from repro_torch.dist import transport as T
from repro_torch.launch.mesh import Mesh
from repro_torch.models import registry as R
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as C
from repro_torch.train.loop import _restore
from repro_torch.train.train_state import make_train_state

from _torch_cpu import one_torch_thread  # noqa: F401
from _torch_ranks import run_ranks

WORKER = str(Path(__file__).resolve().parent / "_torch_fsdp_worker.py")
TIMEOUT = 240
CFG = R.get_config("qwen2.5-3b").reduced()
POLICY = "bf16_sr_kahan"


def _ref_state(seed=7):
    """A reference ``bf16_sr_kahan`` AdamW state with distinctive moments."""
    policy = j_get_policy(POLICY)
    params = JR.init(JR.get_config("qwen2.5-3b").reduced(), jax.random.PRNGKey(0),
                     policy.param_dtype)
    state = j_make_train_state(params, j_adamw(policy, b2=0.997))
    rng = np.random.default_rng(seed)
    noisy = lambda t: jax.tree_util.tree_map(            # noqa: E731
        lambda a: (rng.standard_normal(a.shape) * 0.01).astype(a.dtype), t)
    opt = state.opt_state._replace(m=noisy(state.opt_state.m), v=noisy(state.opt_state.v),
                                   kahan_c=noisy(state.opt_state.kahan_c))
    return state._replace(step=np.int32(3), opt_state=opt)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp_ckpt")
    JC.save(out / "jref", 3, _ref_state())
    run_ranks(WORKER, ["ckpt", str(out)], 2, out / "logs", TIMEOUT)
    return out, [torch.load(out / f"rank{r}_ckpt.pt") for r in range(2)]


def _stored(directory: Path, step: int) -> list[torch.Tensor]:
    man = C.manifest(directory, step=step)
    with np.load(directory / f"step_{step:09d}" / "arrays.npz") as data:
        return [C._stored_tensor(data[f"a{i}"], man["dtypes"][i])
                for i in range(man["n_leaves"])]


def _equal(xs, ys) -> bool:
    return len(xs) == len(ys) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(xs, ys))


def test_sigterm_on_one_rank_resumes_bitwise(ckpt):
    out, ranks = ckpt
    for res in ranks:
        preempted, step, losses = res["stop"]
        assert preempted and step == 2
        assert _equal(res["resumed"], res["whole"])
        assert losses + res["resumed_losses"] == res["whole_losses"]
    # the residual shards moved (grad_accum 2: f32 gradients)
    assert any(float(t.abs().max()) > 0 for t in ranks[0]["whole"][-10:])
    assert C.latest_step(out / "ck") == 4


def _one_process_state(wire="bf16"):
    policy = get_policy(POLICY)
    opt = adamw(policy, b2=0.997)
    tr = T.make_transport(wire=wire)
    return make_train_state(R.init(CFG, 0, policy.param_dtype, device="cpu"), opt,
                            transport=tr), tr


def test_fsdp_checkpoint_restores_under_dp_one_process_and_the_reference(ckpt):
    out, ranks = ckpt
    stored = _stored(out / "ck", 2)
    man = C.manifest(out / "ck", step=2)
    params = C.flatten(R.init(CFG, 0, torch.bfloat16, device="cpu"))
    # full leaves: the parameters' shapes, the residual stacks (1, *shape)
    assert [tuple(s) for s in man["shapes"][-len(params):]] == [
        (1, *p.shape) for p in params]
    assert [tuple(s) for s in man["shapes"][1:1 + len(params)]] == [
        tuple(p.shape) for p in params]
    # under DP-2 (both ranks): the stored leaves; the bf16 wire there rides
    # the data axis (2 replicas), so its residuals restart from zero
    n_res = len(params)
    for res in ranks:
        assert _equal(res["dp_restored"][:-n_res], stored[1:-n_res])
        assert all(float(t.abs().max()) == 0 for t in res["dp_restored"][-n_res:])
    # in one process (one wire replica, as the checkpoint's): every leaf
    state, tr = _one_process_state()
    mgr = C.CheckpointManager(out / "ck")
    state, at = _restore(mgr, state, print, step=2, wire_format="bf16", transport=tr)
    assert at == 2 and state.step == 2 and _equal(C.flatten(state)[1:], stored[1:])
    # the reference reads the port's FSDP checkpoint to the same values
    jlike = _ref_state()
    jlike = jlike._replace(wire_residuals=jax.tree_util.tree_map(
        lambda a: np.zeros((1, *a.shape), np.float32), jlike.params))
    got, at = JC.restore(out / "ck", jlike, step=2)
    theirs = jax.tree_util.tree_leaves(got)[1:]
    for a, b in zip(C.flatten(state)[1:], theirs):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


@pytest.mark.parametrize("name", ["ck_dp", "jref"])
def test_checkpoint_restores_into_fsdp_shards(ckpt, name):
    out, ranks = ckpt
    at = C.latest_step(out / name)
    stored = _stored(out / name, at)
    for rank, res in enumerate(ranks):
        got_at, shards, specs = res[f"{name}_shards"]
        assert got_at == at and res["index"] == rank
        assert any(any(e is not None for e in s) for s in specs)
        for t, full, spec in zip(shards, stored[1:], specs):
            ext = [(d, e) for d, e in enumerate(spec) if e is not None]
            want = full
            for d, _ in ext:
                n = full.shape[d] // 2
                want = want.narrow(d, rank * n, n)
            assert t.dtype == want.dtype and torch.equal(t, want), spec


def test_convert_gives_this_ranks_shards():
    jstate = _ref_state()
    jstate = jstate._replace(wire_residuals=jax.tree_util.tree_map(
        lambda a: np.stack([np.full(a.shape, 1.0, np.float32),
                            np.full(a.shape, 2.0, np.float32)]), jstate.params))
    mesh = Mesh(("pod", "data", "fsdp", "model"), (2, 1, 2, 1))
    placement = PT.Placement(fsdp_axis="fsdp")
    full = from_jax_train_state(jax.tree_util.tree_map(np.asarray, jstate), device="cpu",
                                replica=0)
    pspecs = PT.param_specs(full.params, CFG, mesh, placement)
    specs = F.train_state_specs(full, pspecs, type("W", (), {"wire_axis": "pod"})())
    got = from_jax_train_state(jax.tree_util.tree_map(np.asarray, jstate), device="cpu",
                               specs=specs, mesh=mesh)
    # process 0 of this mesh: pod 0, fsdp 0 — the first shard of every leaf,
    # row 0 of every residual stack
    stack = from_jax_train_state(jax.tree_util.tree_map(np.asarray, jstate), device="cpu",
                                 replica=1).wire_residuals
    assert all(float(r.max()) == 1.0 for r in C.flatten(got.wire_residuals))
    assert all(float(r.max()) == 2.0 for r in C.flatten(stack))
    bare = zip(C.flatten(got._replace(wire_residuals=None)),
               C.flatten(full._replace(wire_residuals=None)), F.flat_specs(specs))
    for t, f, s in bare:
        if isinstance(t, torch.Tensor):
            assert torch.equal(t, F.local_slice(f, s, mesh)), s
    n_sharded = sum(bool(F.sharded_dims(s)) for s in F.flat_specs(specs.params))
    assert n_sharded > 0


def test_stateless_transport_commits_from_process_zero_only(ckpt):
    _, ranks = ckpt
    assert ranks[0]["commits"] == 2 and ranks[1]["commits"] == 0
