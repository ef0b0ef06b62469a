"""Training on the model axis on the CPU: the port's ``(data, model)``
meshes of gloo ranks against the reference's Auto ``(1, 2)`` step and the
port's one-process step.

Reduced qwen2.5-3b from the reference's initial states (its checkpoints,
restored into each rank's shards), one batch of 4 x 16:

* the 1 x 2 gradient phase against the reference's (1, 2) step
  (``AxisType.Auto`` mesh of 2 virtual devices, a subprocess: ROADMAP C4)
  and against the port's one-process gradient phase: under ``fp32`` each
  leaf's gradient within ``FP32_TOL`` of its largest |g|, the loss and the
  norm alike; under ``bf16_sr`` the loss within ``LOSS_TOL`` (the
  reference's bar, ``tests/test_dist.py``) and each leaf within
  ``BF16_TOL`` of one process's (the model axis reassociates the
  row-parallel and the input-gradient sums, and bf16 roundings that flip
  move on: ROADMAP C18) and within ``BF16_TOL`` beyond the one-process
  step's own distance from the reference's (the two packages' bf16
  forward and backward round differently: up to 2.5% of a leaf's largest
  |g| in one process, ``tests/test_torch_dist.py``); the margins are
  printed;
* both ranks bitwise equal on every replicated leaf's gradient and on the
  loss; the gradient norm equals the norm of the gathered gradients
  within f32 reassociation;
* the non-fused SR update of each TP shard equals the one-process
  update's slice given the same gradients, by ``torch.equal`` (the leaf's
  Philox words at the shard's positions);
* the backward run by ``autograd.grad`` from a thread that has no model
  axis installed (the remat recompute included) gives the same gradients
  bitwise: on CUDA autograd's backward runs on a thread of its own;
* ``vocab_parallel_xent`` against ``softmax_xent`` of both packages on
  the gathered logits, ``ignore`` labels included;
* 2 x 2 on 4 ranks through the bf16 wire (fused AdamW on the shards):
  the model groups bitwise equal, the wire's bytes as counted, and its
  checkpoint restores under 1 x 2, in one process and in the reference.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.models import registry as JR
from repro.optim import adamw as j_adamw
from repro.train import checkpoint as JC
from repro.train.train_state import make_train_state as j_make_train_state
from repro.train.train_state import softmax_xent as j_softmax_xent
from repro_torch.core.policy import get_policy
from repro_torch.dist import transport as T
from repro_torch.models import registry as R
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as C
from repro_torch.train.loop import _restore
from repro_torch.train.train_state import make_train_state, softmax_xent

from _torch_cpu import one_torch_thread  # noqa: F401
from _torch_ranks import ROOT, rank_env, run_ranks

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_tp_train_worker as W  # noqa: E402

WORKER = str(Path(__file__).resolve().parent / "_torch_tp_train_worker.py")
TIMEOUT = 300
FP32_TOL = 1e-4
BF16_TOL = 0.02
LOSS_TOL = 0.05

REF_SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[2])
    import numpy as np
    import jax
    from jax.sharding import AxisType
    from repro.core import get_policy
    from repro.dist import fsdp as F
    from repro.dist import partition as PT
    from repro.dist import transport as T
    from repro.dist.axes import activation_sharding
    from repro.models import registry as R
    from repro.optim import adamw, constant
    from repro.optim.base import Optimizer
    from repro.train import checkpoint as C
    from repro.train.step import make_train_step
    from repro.train.train_state import make_train_state
    import _torch_tp_train_worker as W

    out = sys.argv[1]
    cfg = R.get_config("qwen2.5-3b").reduced()
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (W.BATCH, W.SEQ)).astype(np.int32)
    saved = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    batch = {k: jax.numpy.asarray(v) for k, v in saved.items()}
    mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    for name in W.REF_POLICIES:
        policy = get_policy(name)
        params = R.init(cfg, jax.random.PRNGKey(0), policy.param_dtype)
        opt = adamw(policy, b2=0.997)
        C.save(out + f"/init_{name}", 0, make_train_state(params, opt))
        # the update hands the gradients back as the new params
        capture = Optimizer("capture", policy, opt.init, lambda g, s, p, **kw: (g, s))
        pl = PT.Placement()
        pspecs = PT.param_specs(params, cfg, mesh, pl)
        tr = T.make_transport(mesh=mesh, placement=pl, pspecs=pspecs)
        state = make_train_state(params, capture, transport=tr)
        state = jax.device_put(state, F.train_state_shardings(state, cfg, mesh, pl,
                                                              transport=tr))
        step = make_train_step(cfg, policy, capture, constant(1e-3), attn_chunk=W.CHUNK,
                               transport=tr)
        with mesh, activation_sharding(("data",), 1, "model", 2):
            new, m = jax.jit(step)(state, batch, 0)
        for i, g in enumerate(jax.tree_util.tree_leaves(new.params)):
            saved[f"{name}_grad_{i}"] = np.asarray(g, np.float32)
        saved[f"{name}_loss"] = np.asarray(m["loss"])
        saved[f"{name}_grad_norm"] = np.asarray(m["grad_norm"])
    np.savez(out + "/ref.npz", **saved)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess beside the 4-rank launch, then the 2-rank
    one, which reads both."""
    out = tmp_path_factory.mktemp("tp_train")
    flags = ("--xla_force_host_platform_device_count=2 --xla_allow_excess_precision=false "
             "--xla_cpu_multi_thread_eigen=false")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(out), str(Path(WORKER).parent)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                           env=rank_env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu"), cwd=ROOT)
    try:
        run_ranks(WORKER, ["quad", str(out)], 4, out / "quad_logs", TIMEOUT)
        log, _ = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log[-4000:]
    run_ranks(WORKER, ["pair", str(out)], 2, out / "pair_logs", TIMEOUT)
    pair = [torch.load(out / f"rank{r}_pair.pt", weights_only=False) for r in range(2)]
    quad = [torch.load(out / f"rank{r}_quad.pt", weights_only=False) for r in range(4)]
    return out, dict(np.load(out / "ref.npz")), pair, quad


def _share(got, want) -> float:
    """max |got - want| over the largest |want| of a leaf."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("name", W.REF_POLICIES)
def test_gradient_phase_matches_the_reference_and_one_process(runs, name):
    _, ref, pair, _ = runs
    res = pair[0][name]
    tol = FP32_TOL if name == "fp32" else BF16_TOL
    theirs = [torch.from_numpy(ref[f"{name}_grad_{i}"]) for i in range(len(res["full"]))]
    vs_ref = [_share(g, r) for g, r in zip(res["full"], theirs)]
    # the frameworks' own distance, in one process against the reference's
    one_ref = [_share(o, r) for o, r in zip(res["one"], theirs)]
    vs_one = [_share(g, o) for g, o in zip(res["full"], res["one"])]
    loss_ref = abs(float(res["loss"]) - float(ref[f"{name}_loss"]))
    loss_one = abs(float(res["loss"]) - float(res["one_loss"]))
    beyond = max(a - b for a, b in zip(vs_ref, one_ref))
    print(f"[tp-train {name}] gradients within {max(vs_ref):.3e} of the largest |g| of the "
          f"reference's (1, 2) step ({beyond:.3e} beyond one process's {max(one_ref):.3e}) "
          f"and {max(vs_one):.3e} of one process's (bar {tol}); loss within {loss_ref:.3e} "
          f"and {loss_one:.3e}")
    assert max(vs_one) <= tol and beyond <= tol
    if name == "fp32":
        assert max(vs_ref) <= tol
    assert loss_ref <= LOSS_TOL and loss_one <= LOSS_TOL
    if name == "fp32":
        assert loss_ref <= FP32_TOL * abs(float(res["loss"]))
        assert abs(float(res["norm"]) - float(ref[f"{name}_grad_norm"])) <= \
            FP32_TOL * float(res["norm"])
    # the norm is the gathered gradients' norm, reassociated in f32
    assert abs(float(res["norm"]) - float(res["norm_of_full"])) <= 1e-5 * float(res["norm"])


@pytest.mark.parametrize("name", W.REF_POLICIES)
def test_ranks_bitwise_equal(runs, name):
    _, _, pair, _ = runs
    a, b = pair[0][name], pair[1][name]
    assert pair[0]["coords"]["model"] == 0 and pair[1]["coords"]["model"] == 1
    assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["norm"], b["norm"])
    n_sharded = 0
    for ga, gb, fa, fb, spec in zip(a["local"], b["local"], a["full"], b["full"], a["specs"]):
        if any(e is not None for e in spec):
            n_sharded += 1
            assert ga.shape != fa.shape
        else:
            assert torch.equal(ga, gb)
        assert torch.equal(fa, fb)
    assert n_sharded >= 7      # the embedding and the layers' seven kernels


def test_sr_update_on_tp_shards_equals_the_one_process_slice(runs):
    _, _, pair, _ = runs
    for rank, res in enumerate(pair):
        up = res["bf16_sr"]["update"]
        for got, want in zip(up["shards"], up["slices"]):
            assert got.dtype == want.dtype and torch.equal(got, want)
        for got, want in zip(up["shard_moments"], up["moments"]):
            assert torch.equal(got, want)


def test_backward_on_a_thread_without_the_axis_is_bitwise(runs):
    _, _, pair, _ = runs
    for res in pair:
        same, other = res["thread"]
        assert len(same) == len(other)
        for g, h in zip(same, other):
            assert g.dtype == h.dtype and torch.equal(g, h)


def test_vocab_parallel_xent_matches_softmax_xent(runs):
    _, _, pair, _ = runs
    full, labels = W.xent_inputs()
    logits = full.clone().requires_grad_(True)
    want = softmax_xent(logits, labels)
    want.backward()
    j_loss, j_grad = jax.value_and_grad(j_softmax_xent)(jnp.asarray(full.numpy()),
                                                        jnp.asarray(labels.numpy()))
    width = full.shape[-1] // 2
    for rank, res in enumerate(pair):
        got = res["xent"]
        assert torch.equal(got["loss"], pair[0]["xent"]["loss"])
        assert abs(float(got["loss"]) - float(want.detach())) <= 1e-6 * float(j_loss)
        assert abs(float(got["loss"]) - float(j_loss)) <= 1e-6 * float(j_loss)
        cols = slice(rank * width, (rank + 1) * width)
        torch.testing.assert_close(got["grad"], logits.grad[..., cols], rtol=0, atol=1e-7)
        np.testing.assert_allclose(got["grad"].numpy(), np.asarray(j_grad)[..., cols],
                                   rtol=0, atol=1e-7)
        # an ignored position has no gradient
        assert float(got["grad"][0, :W.IGNORED].abs().max()) == 0.0


def test_two_by_two_model_groups_bitwise_and_wire_bytes(runs):
    _, _, _, quad = runs
    by = {(q["coords"]["data"], q["coords"]["model"]): q for q in quad}
    assert sorted(by) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    n_params = quad[0]["n_params"]
    for m in (0, 1):
        a, b = by[0, m], by[1, m]
        # params and optimizer state equal across the data replicas; each
        # replica keeps its own residual rows
        for x, y in zip(a["leaves"][:-n_params], b["leaves"][:-n_params]):
            assert torch.equal(x, y)
        assert a["losses"] == b["losses"]
        # the bf16 wire over data: 2 bytes per local element, per step, each
        # microbatch's gradients summed before one reduce
        assert a["stats"] == {"bfloat16": 2 * a["local_numel"] * W.QUAD_STEPS}
    assert by[0, 0]["losses"] == by[0, 1]["losses"]
    for x, y, spec in zip(by[0, 0]["leaves"], by[0, 1]["leaves"], by[0, 0]["specs"]):
        if "model" not in spec:
            assert torch.equal(x, y)
    assert by[0, 0]["losses"][-1] < by[0, 0]["losses"][0] + 0.5


def _stored(directory: Path, step: int) -> list[torch.Tensor]:
    man = C.manifest(directory, step=step)
    with np.load(directory / f"step_{step:09d}" / "arrays.npz") as data:
        return [C._stored_tensor(data[f"a{i}"], man["dtypes"][i])
                for i in range(man["n_leaves"])]


def _slice(full, spec, coords):
    for d, e in enumerate(spec):
        if e is not None:
            n = full.shape[d] // 2
            full = full.narrow(d, coords[e] * n, n)
    return full


def test_checkpoints_cross_meshes_and_packages(runs):
    out, _, pair, quad = runs
    stored = _stored(out / "ck", W.QUAD_STEPS)
    n_params = quad[0]["n_params"]
    # the 2 x 2 writers' parts are slices of the stored full leaves (the
    # residual stacks (2, *shape): one row per data replica)
    for q in quad:
        for t, full, spec in zip(q["leaves"], stored[1:], q["specs"]):
            assert torch.equal(t, _slice(full, spec, q["coords"]))
    # under 1 x 2: each rank its slice; one wire replica, so the residuals
    # restart from zero
    for res in pair:
        got = res["restored"]
        assert got["step"] == W.QUAD_STEPS
        for t, full, spec in zip(got["leaves"][:-n_params], stored[1:-n_params],
                                 got["specs"]):
            assert t.dtype == full.dtype and torch.equal(t, _slice(full, spec, res["coords"]))
        assert all(float(t.abs().max()) == 0 for t in got["leaves"][-n_params:])
    # in one process: the stored leaves
    policy = get_policy(W.QUAD_POLICY)
    opt = adamw(policy, b2=0.997)
    tr = T.make_transport(wire="bf16")
    state = make_train_state(R.init(W.CFG, 0, policy.param_dtype, device="cpu"), opt,
                             transport=tr)
    state, at = _restore(C.CheckpointManager(out / "ck"), state, print,
                         wire_format=tr.wire_format, transport=tr)
    assert at == W.QUAD_STEPS
    assert all(torch.equal(a, b) for a, b in
               zip(C.flatten(state)[1:-n_params], stored[1:-n_params]))
    # the reference reads it
    jpol = j_get_policy(W.QUAD_POLICY)
    jparams = JR.init(JR.get_config("qwen2.5-3b").reduced(), jax.random.PRNGKey(0),
                      jpol.param_dtype)
    jlike = j_make_train_state(jparams, j_adamw(jpol, b2=0.997))
    jlike = jlike._replace(wire_residuals=jax.tree_util.tree_map(
        lambda a: np.zeros((2, *a.shape), np.float32), jlike.params))
    got, at = JC.restore(out / "ck", jlike, step=W.QUAD_STEPS)
    for a, b in zip(stored[1:], jax.tree_util.tree_leaves(got)[1:]):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
