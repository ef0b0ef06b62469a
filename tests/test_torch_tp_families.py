"""Tensor-parallel serving of the MoE and Mamba families on the CPU: the
port's ``Engine(mesh=)`` and serve step on gloo ranks against the
reference's serve step on an ``Auto`` (1, 2) mesh and one process.

Reduced mixtral-8x22b (MoE top-2, SWA), llama4-scout-17b-a16e (MoE top-1
with the shared expert) and falcon-mamba-7b (Mamba-1, tied embedding) from
the reference's weights, the requests and the teacher-forced schedule of
``tests/_torch_tp_worker.py``, ``bf16_standard``:

* the serve step's logits on the schedule on the port's 1 x 2 mesh lie
  within ``LOGIT_TOL`` of the reference's step on a (1, 2) mesh of 2
  virtual devices (``AxisType.Auto``: ROADMAP C4) and of the port's own
  one-process step (the tolerance of ``tests/test_torch_tp_serve.py``);
  under ``fp32`` the 1 x 2 step is one process's within 1e-5 of the
  logits' scale (the row-parallel f32 sums' reassociation is the split's
  only trace: a wrong shard, slice or exchange moves them far more);
* the 1 x 2 engine's tokens agree with one process's on at least
  ``TOKEN_AGREEMENT`` of them (C18), the first token of every request;
* both ranks bitwise equal; paged 1 x 2 ≡ contiguous 1 x 2; for
  falcon-mamba 2 x 2 ≡ 1 x 2 (the sharded Mamba cache under a data axis);
* ``axes.own_halves`` (Mamba's ``in_proj`` exchange) forward and backward
  equal the unsplit product's columns and gradient;
* the collectives per serve step: MoE 2 per layer (``wo``, the experts'
  down product; 3 with llama4's shared expert), Mamba 3 per layer (the
  exchange, ``x_proj``, ``out_proj``), plus the embedding and the logits.
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
import _torch_tp_worker as W  # noqa: E402

WORKER = str(Path(__file__).resolve().parent / "_torch_tp_worker.py")
TIMEOUT = 300
ARCHS = ("mixtral-8x22b", "llama4-scout-17b-a16e", "falcon-mamba-7b")
LOGIT_TOL = 0.125
TOKEN_AGREEMENT = 0.9
# collectives per serve step: per layer, then the embedding and the logits
PER_LAYER = {"mixtral-8x22b": 2, "llama4-scout-17b-a16e": 3, "falcon-mamba-7b": 3}

REF_SCRIPT = textwrap.dedent("""
    import contextlib
    import sys
    sys.path.insert(0, sys.argv[2])
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from repro.core import get_policy
    from repro.core.qarith import QArith
    from repro.dist import partition as PT
    from repro.dist.axes import activation_sharding
    from repro.models import registry as R
    from repro.train.step import make_serve_step
    import _torch_tp_worker as W

    out = sys.argv[1]
    policy = get_policy(W.POLICY)
    mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    named = lambda tree: jax.tree_util.tree_map(                     # noqa: E731
        lambda s: NamedSharding(mesh, s), tree,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    saved = {}
    for arch in sys.argv[3:]:
        cfg = R.get_config(arch).reduced()
        params = R.init(cfg, jax.random.PRNGKey(0), policy.param_dtype)
        params = jax.device_put(params, named(PT.param_specs(params, cfg, mesh)))
        step = jax.jit(make_serve_step(cfg, policy, return_logits=True))
        cache = R.make_cache(QArith(policy), params, cfg, {}, batch_size=W.N_SLOTS,
                             max_len=W.MAX_LEN, dtype=policy.compute_dtype)
        cache = jax.device_put(cache, named(PT.cache_specs(cache, cfg, mesh)))
        logits = []
        with mesh, activation_sharding(("data",), 1, "model", 2):
            for t, row in enumerate(W.schedule(cfg.vocab)):
                n = W.N_SLOTS
                _, lg, cache = step(params, cache, jnp.asarray(row)[:, None],
                                    jnp.full((n,), t, jnp.int32), jnp.ones((n,), bool),
                                    jnp.full((n,), t == 0))
                logits.append(np.asarray(lg))
        saved[arch] = np.stack(logits)
    np.savez(out + "/ref.npz", **saved)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess beside the port's 4-rank launch, then the
    2-rank one."""
    out = tmp_path_factory.mktemp("tp_families")
    flags = ("--xla_force_host_platform_device_count=2 --xla_allow_excess_precision=false "
             "--xla_cpu_multi_thread_eigen=false")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(out), str(Path(WORKER).parent),
                            *ARCHS], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                           env=rank_env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu"), cwd=ROOT)
    rank_kw = dict(env=rank_env(JAX_PLATFORMS="cpu"))
    try:
        run_ranks(WORKER, ["family_quad", str(out), "falcon-mamba-7b"], 4, out / "quad_logs",
                  TIMEOUT, **rank_kw)
        run_ranks(WORKER, ["family", str(out), *ARCHS], 2, out / "pair_logs", TIMEOUT,
                  **rank_kw)
        log, _ = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log[-4000:]
    pair = {a: [torch.load(out / f"rank{r}_family_{a}.pt", weights_only=False)
                for r in range(2)] for a in ARCHS}
    quad = [torch.load(out / f"rank{r}_family_quad_falcon-mamba-7b.pt", weights_only=False)
            for r in range(4)]
    return dict(np.load(out / "ref.npz")), pair, quad


def _tokens(d: dict) -> dict:
    return {k: np.asarray(v) for k, v in d.items() if isinstance(k, int)}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[r], b[r]) for r in a)


@pytest.mark.parametrize("arch", ARCHS)
def test_schedule_logits_match_the_reference_on_a_model_axis(runs, arch):
    ref, pair, _ = runs
    for res in pair[arch]:
        assert res["tp_schedule"].shape == ref[arch].shape
        assert np.abs(res["tp_schedule"] - ref[arch]).max() <= LOGIT_TOL
        assert np.abs(res["tp_schedule"] - res["one_schedule"]).max() <= LOGIT_TOL
    assert np.array_equal(pair[arch][0]["tp_schedule"], pair[arch][1]["tp_schedule"])


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_model_axis_is_one_process_within_f32_rounding(runs, arch):
    _, pair, _ = runs
    tp, one = pair[arch][0]["fp32_schedule"]
    assert np.abs(tp - one).max() <= 1e-5 * np.abs(one).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_engine_tokens_against_one_process(runs, arch):
    _, pair, _ = runs
    tp, one = _tokens(pair[arch][0]["tp"]), _tokens(pair[arch][0]["one"])
    same = sum(int((tp[r] == one[r]).sum()) for r in tp)
    total = sum(one[r].size for r in one)
    assert total == sum(W.GENS) and same >= TOKEN_AGREEMENT * total, (same, total)
    assert all(tp[r][0] == one[r][0] for r in tp)


@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_bitwise_and_paged_equals_contiguous(runs, arch):
    _, pair, _ = runs
    a, b = pair[arch]
    assert [r["coords"]["model"] for r in pair[arch]] == [0, 1]
    for key in ("tp", "tp_paged", "one"):
        assert _equal(_tokens(a[key]), _tokens(b[key])), key
    assert _equal(_tokens(a["tp_paged"]), _tokens(a["tp"]))


def test_mamba_two_by_two_equals_one_by_two(runs):
    """The sharded Mamba cache under a data axis: each data rank holds its
    slots' state of its model rank's channels, and the tokens are 1 x 2's."""
    _, pair, quad = runs
    assert sorted((r["coords"]["data"], r["coords"]["model"]) for r in quad) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for res in quad:
        assert _equal(_tokens(res["tokens"]), _tokens(pair["falcon-mamba-7b"][0]["tp"]))


@pytest.mark.parametrize("rank", [0, 1])
def test_in_proj_exchange_matches_the_unsplit_product(runs, rank):
    _, pair, _ = runs
    oh = pair["falcon-mamba-7b"][rank]["own_halves"]
    assert torch.equal(oh["fwd"], oh["want"])
    assert torch.allclose(oh["grad"], oh["want_grad"], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_per_serve_step(runs, arch):
    """The schedule's steps each run the counted collectives: per layer
    MoE's ``wo`` and expert sums (and the shared expert's ``w_down``),
    Mamba's exchange, ``x_proj`` and ``out_proj``; then the embedding and
    the logits gathers."""
    _, pair, _ = runs
    from repro_torch.models import registry as R
    n_layers = R.get_config(arch).reduced().n_layers
    want = W.SCHEDULE_STEPS * (PER_LAYER[arch] * n_layers + 2)
    assert pair[arch][0]["schedule_calls"] == want
