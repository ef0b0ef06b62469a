"""The port's data-parallel step across processes ≡ the reference's wire
replicas, on the CPU (2 gloo ranks against 2 virtual XLA devices).

* The reference runs in a subprocess with 2 virtual CPU devices, on Auto
  meshes it builds itself (``jax.make_mesh`` gives Explicit axes on jax
  0.9, where the reference's own ``launch/mesh.py`` meshes fail: ROADMAP
  C4), through its own ``make_transport``, ``make_train_state``,
  ``train_state_shardings`` and ``make_train_step``, with an optimizer
  whose update hands back the reduced gradients. It saves its initial
  state (a reference checkpoint), the batch, its wire bits (each replica's
  ``jax.random.bits`` draw) and its reduced gradients, residuals, loss and
  gradient norm.
* Two ranks of the port (``repro_torch.launch.dist_launch``, gloo) restore
  that state, take the rows the reference gives their replica, and run the
  gradient phase with the reference's wire bits: the fp32 and bf16 wires
  on a pod axis, with ``grad_accum`` 1 and 2, and on the data axis (fp32:
  the step's own mean, the reference's GSPMD mean). The policy is
  ``fp32``: its f32 gradients agree between the frameworks to ~1e-6, so
  the comparison sees the wire (the bf16 wire rounds real bits away). A
  16-bit policy's per-replica gradients differ between the frameworks by
  up to 2.4% of a leaf's largest |g| before any wire (their bf16 forward
  and backward round differently). Loss and gradient norm within 0.2%
  (``LOSS_RTOL``); reduced gradients and each rank's residual row within
  1% of the leaf's largest |g| (``GRAD_TOL``: an f32 difference in the
  last bits can move the SR of one element by one bf16 step, under 0.8%
  of it). Both ranks' reduced gradients are bitwise equal, and the wire
  moved 2 bytes per element at bf16 and 4 at fp32.
* Three steps of the bf16 wire (fused AdamW, ``grad_accum`` 2, whose f32
  gradients leave residuals): both ranks' parameters, optimizer state and
  metrics are bitwise equal; their residual rows, each rank's own, differ.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(Path(__file__).resolve().parent / "_torch_dist_worker.py")
LOSS_RTOL = 2e-3
GRAD_TOL = 1e-2
TIMEOUT = 240

REF_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.core import get_policy
    from repro.dist import partition as PT
    from repro.dist import fsdp as F
    from repro.dist import transport as T
    from repro.dist.axes import activation_sharding
    from repro.models import registry as R
    from repro.optim import adamw, constant
    from repro.optim.base import Optimizer
    from repro.train import checkpoint as C
    from repro.train.step import make_train_step
    from repro.train.train_state import make_train_state

    out = sys.argv[1]
    policy = get_policy("fp32")
    cfg = R.get_config("qwen2.5-3b").reduced()
    params = R.init(cfg, jax.random.PRNGKey(0), policy.param_dtype)
    opt = adamw(policy, b2=0.997)
    C.save(out + "/init", 0, make_train_state(params, opt))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    # the update hands the reduced gradients back as the new params
    capture = Optimizer("capture", policy, opt.init,
                        lambda g, s, p, **kw: (g, s))
    saved = {"tokens": tokens, "labels": labels}
    leaves = jax.tree_util.tree_leaves(params)
    CASES = [("fp32_pod", (2, 1, 1), "fp32", 1), ("bf16_pod", (2, 1, 1), "bf16", 1),
             ("fp32_pod_accum2", (2, 1, 1), "fp32", 2),
             ("bf16_pod_accum2", (2, 1, 1), "bf16", 2),
             ("fp32_data", (2, 1), "fp32", 1), ("bf16_data", (2, 1), "bf16", 1)]
    for name, shape, wire, accum in CASES:
        axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
        mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))
        pl = PT.Placement()
        pspecs = PT.param_specs(params, cfg, mesh, pl)
        tr = T.make_transport(mesh=mesh, placement=pl, pspecs=pspecs, wire=wire)
        state = make_train_state(params, capture, transport=tr)
        state = jax.device_put(state, F.train_state_shardings(state, cfg, mesh, pl,
                                                              transport=tr))
        step = make_train_step(cfg, policy, capture, constant(1e-3), attn_chunk=8,
                               transport=tr, grad_accum=accum)
        hints, hsize = tr.hint_axes(mesh)
        with mesh, activation_sharding(hints, hsize, "model", 1):
            new, m = jax.jit(step)(state, batch, 0)
        for i, g in enumerate(jax.tree_util.tree_leaves(new.params)):
            saved[f"{name}_grad_{i}"] = np.asarray(g, np.float32)
        if new.wire_residuals is not None:
            for i, r in enumerate(jax.tree_util.tree_leaves(new.wire_residuals)):
                saved[f"{name}_res_{i}"] = np.asarray(r)
        saved[f"{name}_loss"] = np.asarray(m["loss"])
        saved[f"{name}_grad_norm"] = np.asarray(m["grad_norm"])
        # the wire's bits, as each replica draws them (train/step.py:151,
        # optim/grad_compress.py:97)
        wire_key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 0), 7)
        for r in range(2):
            keys = jax.random.split(jax.random.fold_in(wire_key, r), len(leaves))
            for i, (k, w) in enumerate(zip(keys, leaves)):
                saved[f"{name}_bits{r}_{i}"] = np.asarray(
                    jax.random.bits(k, w.shape, jnp.uint32))
    np.savez(out + "/ref.npz", **saved)
""")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    # one thread each: the ranks and the other test workers share the cores
    env["OMP_NUM_THREADS"] = "1"
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _launch(scenario: str, out: Path, n: int = 2, timeout: float = TIMEOUT):
    """``scenario`` on n gloo ranks through the port's launcher."""
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dist_launch", "-n", str(n),
         "--timeout", str(timeout - 10), "--", sys.executable, WORKER, scenario, str(out)],
        capture_output=True, text=True, timeout=timeout, env=_env(), cwd=ROOT)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_ref")
    flags = ("--xla_force_host_platform_device_count=2 --xla_allow_excess_precision=false "
             "--xla_cpu_multi_thread_eigen=false")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out)], capture_output=True,
                       text=True, timeout=TIMEOUT, env=_env(XLA_FLAGS=flags,
                                                            JAX_PLATFORMS="cpu"), cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    run = _launch("ref", out)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    return out, np.load(out / "ref.npz")


CASES = ["fp32_pod", "bf16_pod", "fp32_pod_accum2", "bf16_pod_accum2", "fp32_data",
         "bf16_data"]


@pytest.mark.parametrize("case", CASES)
def test_two_rank_step_matches_reference_replicas(reference, case):
    out, ref = reference
    ranks = [torch.load(out / f"rank{r}_{case}.pt") for r in range(2)]
    for r, got in enumerate(ranks):
        assert float(got["loss"]) == pytest.approx(float(ref[f"{case}_loss"]), rel=LOSS_RTOL)
        assert float(got["grad_norm"]) == pytest.approx(float(ref[f"{case}_grad_norm"]),
                                                        rel=LOSS_RTOL)
        for i, g in enumerate(got["grads"]):
            want = ref[f"{case}_grad_{i}"]
            assert g.dtype == torch.float32 and tuple(g.shape) == want.shape
            scale = float(np.abs(want).max())
            err = float(np.abs(g.numpy() - want).max())
            assert err <= GRAD_TOL * scale, (case, r, i, err, scale)
        if case.startswith("bf16"):
            assert got["replica"] == r
            for i, row in enumerate(got["residuals"]):
                want = ref[f"{case}_res_{i}"][r:r + 1]
                assert tuple(row.shape) == want.shape
                scale = float(np.abs(ref[f"{case}_grad_{i}"]).max())
                err = float(np.abs(row.numpy() - want).max())
                assert err <= GRAD_TOL * scale, (case, r, i, err, scale)
        else:
            assert got["residuals"] is None
    # every rank reduces the same payloads in the same order
    for a, b in zip(ranks[0]["grads"], ranks[1]["grads"]):
        assert torch.equal(a, b)
    assert torch.equal(ranks[0]["loss"], ranks[1]["loss"])
    # what the wire moved per rank: every gradient element once, at the
    # carrier's width (the fp32 data case is the step's own f32 mean)
    n = sum(g.numel() for g in ranks[0]["grads"])
    width = 2 if case.startswith("bf16") else 4
    key = "bfloat16" if width == 2 else "float32"
    assert ranks[0]["stats"] == {key: n * width}


def test_ranks_stay_bitwise_equal(tmp_path):
    run = _launch("equal", tmp_path)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    a, b = (torch.load(tmp_path / f"rank{r}_equal.pt") for r in range(2))
    assert a["step"] == b["step"] == 3
    assert a["metrics"] == b["metrics"]
    # params, m, v, c and the residual rows (P leaves each), c1 and c2
    n_res = (len(a["leaves"]) - 2) // 5
    shared = a["leaves"][:len(a["leaves"]) - n_res], b["leaves"][:len(b["leaves"]) - n_res]
    for x, y in zip(*shared):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # the residual rows are each rank's own: they differ
    assert not all(torch.equal(x, y) for x, y in
                   zip(a["leaves"][-n_res:], b["leaves"][-n_res:]))
