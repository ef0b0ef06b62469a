"""Training the MoE and Mamba families on the model axis on the CPU: the
port's 1 x 2 gradient phase on gloo ranks against the reference's Auto
(1, 2) step and the port's one-process step.

Reduced mixtral-8x22b, llama4-scout-17b-a16e and falcon-mamba-7b from the
reference's initial states (its checkpoints, restored into each rank's
shards), one batch of 4 x 16, with the tolerances of
``tests/test_torch_tp_train.py``:

* under ``fp32`` every leaf's gradient within ``FP32_TOL`` of its largest
  |g| of the reference's (1, 2) step and of one process's, the loss and
  the norm alike; under ``bf16_sr`` the loss within ``LOSS_TOL`` and each
  leaf within ``BF16_TOL`` of one process's and within ``BF16_TOL`` beyond
  the one-process step's own distance from the reference's;
* MoE's router gradient, every layer's, is one process's within f32
  reassociation: the expert branch's input alone passes ``copy_to_model``,
  so the router's whole input-gradient is not summed twice;
* both ranks bitwise equal on the loss, the norm and every replicated
  leaf (the router, conv, ``A_log``, ``D_skip``, the biases, the norms);
* the non-fused SR update of each shard (the experts' F slices, Mamba's
  ``d_inner`` slices) equals the one-process update's slice, bitwise;
* ``launch.train --model-parallel 2`` trains reduced mixtral and
  falcon-mamba on two ranks.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from _torch_ranks import ROOT, rank_env, run_ranks

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_tp_train_worker as W  # noqa: E402

WORKER = str(Path(__file__).resolve().parent / "_torch_tp_train_worker.py")
TIMEOUT = 300
ARCHS = ("mixtral-8x22b", "llama4-scout-17b-a16e", "falcon-mamba-7b")
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
    mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    for arch in sys.argv[3:]:
        cfg = R.get_config(arch).reduced()
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, cfg.vocab, (W.BATCH, W.SEQ)).astype(np.int32)
        saved = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
        batch = {k: jax.numpy.asarray(v) for k, v in saved.items()}
        for name in W.REF_POLICIES:
            policy = get_policy(name)
            params = R.init(cfg, jax.random.PRNGKey(0), policy.param_dtype)
            opt = adamw(policy, b2=0.997)
            C.save(out + f"/init_{arch}_{name}", 0, make_train_state(params, opt))
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
        np.savez(out + f"/ref_{arch}.npz", **saved)
""")

LAUNCH_ARCHS = ("mixtral-8x22b", "falcon-mamba-7b")


def _launch(arch: str, log_dir: Path) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "repro_torch.launch.dist_launch", "-n", "2", "--timeout",
           str(TIMEOUT - 10), "--log-dir", str(log_dir), "--", sys.executable, "-m",
           "repro_torch.launch.train", "--arch", arch, "--reduced", "--device", "cpu",
           "--data-parallel", "1", "--model-parallel", "2", "--steps", "2", "--batch", "2",
           "--seq", "16"]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=rank_env(), cwd=ROOT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the launcher's runs, then the port's
    2-rank launch, which reads the reference's."""
    out = tmp_path_factory.mktemp("tp_families_train")
    flags = ("--xla_force_host_platform_device_count=2 --xla_allow_excess_precision=false "
             "--xla_cpu_multi_thread_eigen=false")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(out), str(Path(WORKER).parent),
                            *ARCHS], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                           env=rank_env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu"), cwd=ROOT)
    launches = {a: _launch(a, out / f"launch_{a}") for a in LAUNCH_ARCHS}
    try:
        log, _ = ref.communicate(timeout=TIMEOUT)
        assert ref.returncode == 0, log[-4000:]
        run_ranks(WORKER, ["family", str(out), *ARCHS], 2, out / "pair_logs", TIMEOUT)
        launched = {}
        for a, p in launches.items():
            out_text = p.communicate(timeout=TIMEOUT)[0]
            log0 = out / f"launch_{a}" / "rank0.log"
            launched[a] = (out_text + (log0.read_text() if log0.exists() else ""),
                           p.returncode)
    finally:
        for p in (ref, *launches.values()):
            if p.poll() is None:
                p.kill()
    pair = {a: [torch.load(out / f"rank{r}_family_{a}.pt", weights_only=False)
                for r in range(2)] for a in ARCHS}
    refs = {a: dict(np.load(out / f"ref_{a}.npz")) for a in ARCHS}
    return refs, pair, launched


def _share(got, want) -> float:
    """max |got - want| over the largest |want| of a leaf."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("name", W.REF_POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_gradient_phase_matches_the_reference_and_one_process(runs, arch, name):
    refs, pairs, _ = runs
    ref, res = refs[arch], pairs[arch][0][name]
    tol = FP32_TOL if name == "fp32" else BF16_TOL
    theirs = [torch.from_numpy(ref[f"{name}_grad_{i}"]) for i in range(len(res["full"]))]
    vs_ref = [_share(g, r) for g, r in zip(res["full"], theirs)]
    one_ref = [_share(o, r) for o, r in zip(res["one"], theirs)]
    vs_one = [_share(g, o) for g, o in zip(res["full"], res["one"])]
    loss_ref = abs(float(res["loss"]) - float(ref[f"{name}_loss"]))
    loss_one = abs(float(res["loss"]) - float(res["one_loss"]))
    beyond = max(a - b for a, b in zip(vs_ref, one_ref))
    print(f"[tp-families {arch} {name}] gradients within {max(vs_ref):.3e} of the largest |g| "
          f"of the reference's (1, 2) step ({beyond:.3e} beyond one process's "
          f"{max(one_ref):.3e}) and {max(vs_one):.3e} of one process's (bar {tol}); loss "
          f"within {loss_ref:.3e} and {loss_one:.3e}")
    assert max(vs_one) <= tol and beyond <= tol
    if name == "fp32":
        assert max(vs_ref) <= tol
        assert loss_ref <= FP32_TOL * abs(float(res["loss"]))
        assert abs(float(res["norm"]) - float(ref[f"{name}_grad_norm"])) <= \
            FP32_TOL * float(res["norm"])
    assert loss_ref <= LOSS_TOL and loss_one <= LOSS_TOL
    assert abs(float(res["norm"]) - float(res["norm_of_full"])) <= 1e-5 * float(res["norm"])


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_router_gradient_is_one_processs(runs, arch):
    """Under ``fp32`` every layer's router gradient, and the embedding's,
    within f32 reassociation of one process's: a ``copy_to_model`` on the
    router's input would sum its whole input-gradient over the two ranks
    and double that share of every earlier layer's gradients."""
    _, pairs, _ = runs
    res = pairs[arch][0]["fp32"]
    routers = [i for i, p in enumerate(res["paths"]) if p.endswith("router")]
    assert routers
    for i in routers + [res["paths"].index("embed.embedding")]:
        assert _share(res["full"][i], res["one"][i]) <= 1e-5, res["paths"][i]


@pytest.mark.parametrize("name", W.REF_POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_bitwise_equal(runs, arch, name):
    _, pairs, _ = runs
    a, b = pairs[arch][0][name], pairs[arch][1][name]
    assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["norm"], b["norm"])
    n_sharded = 0
    for ga, gb, fa, fb, spec in zip(a["local"], b["local"], a["full"], b["full"], a["specs"]):
        if any(e is not None for e in spec):
            n_sharded += 1
            assert ga.shape != fa.shape
        else:
            assert torch.equal(ga, gb)
        assert torch.equal(fa, fb)
    # the embedding and, per layer group, the sharded kernels: attention's
    # four and the experts' three (MoE), in_proj, x_proj, dt_proj, out_proj
    # (Mamba)
    assert n_sharded >= (8 if arch != "falcon-mamba-7b" else 5)


@pytest.mark.parametrize("arch", ARCHS)
def test_sr_update_on_tp_shards_equals_the_one_process_slice(runs, arch):
    _, pairs, _ = runs
    for res in pairs[arch]:
        up = res["bf16_sr"]["update"]
        for got, want in zip(up["shards"], up["slices"]):
            assert got.dtype == want.dtype and torch.equal(got, want)
        for got, want in zip(up["shard_moments"], up["moments"]):
            assert torch.equal(got, want)


@pytest.mark.parametrize("arch", LAUNCH_ARCHS)
def test_launcher_trains_on_the_model_axis(runs, arch):
    _, _, launched = runs
    log, rc = launched[arch]
    assert rc == 0, log[-3000:]
    assert "[train] done at step 2" in log
