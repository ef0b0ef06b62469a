"""Training the RG-LRU hybrid and the encoder-decoder on the model axis on
the CPU, with head counts and a vocabulary the axis does not divide: the
port's 1 x 2 gradient phase on gloo ranks against the reference's Auto
(1, 2) step and the port's one-process step.

From the reference's initial states (its checkpoints, restored into each
rank's shards), one batch of 4 x 16 (whisper's with 16 source frames),
four configs (``_torch_tp_train_worker.configs``): reduced recurrentgemma-2b
(1 kv head: k and v gathered), the same with 5 query heads (the padded
head split), reduced whisper-base (vocabulary 512, vocab-parallel) and the
same with a vocabulary of 515 (embedding and tied head whole on every
rank). The tolerances of ``tests/test_torch_tp_families_train.py``:

* under ``fp32`` every leaf's gradient within ``FP32_TOL`` of its largest
  |g| of the reference's (1, 2) step and of one process's, the loss and
  the norm alike; under ``bf16_sr`` the loss within ``LOSS_TOL`` and each
  leaf within ``BF16_TOL`` of one process's and within ``BF16_TOL`` beyond
  the one-process step's own distance from the reference's;
* under ``fp32`` the whole embedding's gradient (the lookup's and the tied
  head's) within f32 reassociation of one process's: a ``copy_to_model``
  on the final norm's output, or a vocab-parallel lookup, would count it
  once per rank;
* both ranks bitwise equal on the loss, the norm and every replicated or
  whole leaf; the non-fused SR update of each shard and whole leaf equals
  the one-process update's slice, bitwise;
* ``launch.train --model-parallel 2`` trains reduced recurrentgemma on
  two ranks, and on 2 x 2 through the bf16 wire on four.
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
SPECS = ("recurrentgemma-2b", "recurrentgemma-2b:n_heads=5", "whisper-base",
         "whisper-base:vocab=515")
FP32_TOL = 1e-4
BF16_TOL = 0.02
LOSS_TOL = 0.05
SRC_LEN = 16

REF_SCRIPT = textwrap.dedent("""
    import dataclasses
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
    from _torch_ranks import config_overrides

    out, src_len = sys.argv[1], int(sys.argv[3])
    mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    for spec in sys.argv[4:]:
        arch, over = config_overrides(spec)
        cfg = dataclasses.replace(R.get_config(arch).reduced(), **over)
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, cfg.vocab, (W.BATCH, W.SEQ)).astype(np.int32)
        saved = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
        if cfg.encdec:
            saved["src_embeds"] = rng.standard_normal((W.BATCH, src_len, cfg.d_model)).astype(
                np.float32)
        batch = {k: jax.numpy.asarray(v) for k, v in saved.items()}
        for name in W.REF_POLICIES:
            policy = get_policy(name)
            params = R.init(cfg, jax.random.PRNGKey(0), policy.param_dtype)
            opt = adamw(policy, b2=0.997)
            C.save(out + f"/init_{spec}_{name}", 0, make_train_state(params, opt))
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
        np.savez(out + f"/ref_{spec}.npz", **saved)
""")


# the launcher's runs of reduced recurrentgemma: 1 x 2, and 2 x 2 through
# the bf16 wire on the data axis
LAUNCHES = {"1x2": ["--data-parallel", "1", "--model-parallel", "2"],
            "2x2-bf16-wire": ["--data-parallel", "2", "--model-parallel", "2",
                              "--grad-wire", "bf16"]}


def _launch(log_dir: Path, mesh: list) -> subprocess.Popen:
    n = int(mesh[1]) * int(mesh[3])
    cmd = [sys.executable, "-m", "repro_torch.launch.dist_launch", "-n", str(n), "--timeout",
           str(TIMEOUT - 10), "--log-dir", str(log_dir), "--", sys.executable, "-m",
           "repro_torch.launch.train", "--arch", "recurrentgemma-2b", "--reduced", "--device",
           "cpu", *mesh, "--steps", "2", "--batch", "4", "--seq", "16"]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=rank_env(), cwd=ROOT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the launcher's runs, then the port's
    2-rank launch, which reads the reference's."""
    out = tmp_path_factory.mktemp("tp_hybrid_train")
    flags = ("--xla_force_host_platform_device_count=2 --xla_allow_excess_precision=false "
             "--xla_cpu_multi_thread_eigen=false")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(out), str(Path(WORKER).parent),
                            str(SRC_LEN), *SPECS], stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True,
                           env=rank_env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu"), cwd=ROOT)
    launches = {name: _launch(out / f"launch_{name}", mesh) for name, mesh in LAUNCHES.items()}
    try:
        log, _ = ref.communicate(timeout=TIMEOUT)
        assert ref.returncode == 0, log[-4000:]
        run_ranks(WORKER, ["family", str(out), *SPECS], 2, out / "pair_logs", TIMEOUT)
        launched = {}
        for name, p in launches.items():
            text = p.communicate(timeout=TIMEOUT)[0]
            log0 = out / f"launch_{name}" / "rank0.log"
            launched[name] = (text + (log0.read_text() if log0.exists() else ""),
                              p.returncode)
    finally:
        for p in (ref, *launches.values()):
            if p.poll() is None:
                p.kill()
    pair = {s: [torch.load(out / f"rank{r}_family_{s}.pt", weights_only=False)
                for r in range(2)] for s in SPECS}
    refs = {s: dict(np.load(out / f"ref_{s}.npz")) for s in SPECS}
    return refs, pair, launched


def _share(got, want) -> float:
    """max |got - want| over the largest |want| of a leaf."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("name", W.REF_POLICIES)
@pytest.mark.parametrize("spec", SPECS)
def test_gradient_phase_matches_the_reference_and_one_process(runs, spec, name):
    refs, pairs, _ = runs
    ref, res = refs[spec], pairs[spec][0][name]
    tol = FP32_TOL if name == "fp32" else BF16_TOL
    theirs = [torch.from_numpy(ref[f"{name}_grad_{i}"]) for i in range(len(res["full"]))]
    vs_ref = [_share(g, r) for g, r in zip(res["full"], theirs)]
    one_ref = [_share(o, r) for o, r in zip(res["one"], theirs)]
    vs_one = [_share(g, o) for g, o in zip(res["full"], res["one"])]
    loss_ref = abs(float(res["loss"]) - float(ref[f"{name}_loss"]))
    loss_one = abs(float(res["loss"]) - float(res["one_loss"]))
    beyond = max(a - b for a, b in zip(vs_ref, one_ref))
    print(f"[tp-hybrid {spec} {name}] gradients within {max(vs_ref):.3e} of the largest |g| "
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


@pytest.mark.parametrize("spec", SPECS)
def test_embedding_gradient_is_one_processs(runs, spec):
    """Under ``fp32`` the embedding's gradient (the tied head's and the
    lookup's), whole or vocab-parallel, within f32 reassociation of one
    process's; with a whole vocabulary the leaf is replicated."""
    _, pairs, _ = runs
    res = pairs[spec][0]["fp32"]
    i = res["paths"].index("embed.embedding")
    assert _share(res["full"][i], res["one"][i]) <= 1e-5
    whole = W.configs(spec).vocab % 2 != 0
    assert (res["specs"][i] == (None, None)) == whole
    assert (res["local"][i].shape == res["one"][i].shape) == whole


@pytest.mark.parametrize("name", W.REF_POLICIES)
@pytest.mark.parametrize("spec", SPECS)
def test_ranks_bitwise_equal(runs, spec, name):
    _, pairs, _ = runs
    a, b = pairs[spec][0][name], pairs[spec][1][name]
    assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["norm"], b["norm"])
    n_sharded = 0
    for ga, gb, fa, fb, s in zip(a["local"], b["local"], a["full"], b["full"], a["specs"]):
        if any(e is not None for e in s):
            n_sharded += 1
            assert ga.shape != fa.shape
        else:
            assert torch.equal(ga, gb)
        assert torch.equal(fa, fb)
    # per layer group: attention's four kernels and the MLP's three, and
    # RG-LRU's six (in_x, in_gate, w_r, w_i, out); whisper's two stacks
    assert n_sharded >= 10


@pytest.mark.parametrize("spec", SPECS)
def test_sr_update_on_tp_shards_equals_the_one_process_slice(runs, spec):
    _, pairs, _ = runs
    for res in pairs[spec]:
        up = res["bf16_sr"]["update"]
        for got, want in zip(up["shards"], up["slices"]):
            assert got.dtype == want.dtype and torch.equal(got, want)
        for got, want in zip(up["shard_moments"], up["moments"]):
            assert torch.equal(got, want)


@pytest.mark.parametrize("mesh", LAUNCHES)
def test_launcher_trains_recurrentgemma_on_the_model_axis(runs, mesh):
    _, _, launched = runs
    log, rc = launched[mesh]
    assert rc == 0, log[-3000:]
    assert "[train] done at step 2" in log
