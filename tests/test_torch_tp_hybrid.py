"""Tensor-parallel serving of the RG-LRU hybrid and the encoder-decoder on
the CPU, with head counts and a vocabulary the model axis does not divide:
the port's serve step on gloo ranks against the reference's on an
``Auto`` (1, 2) mesh and one process.

From the reference's weights, ``bf16_standard``, the requests and the
teacher-forced schedule of ``tests/_torch_tp_worker.py``, four configs
(``_torch_tp_worker.configs``):

* reduced recurrentgemma-2b (4 query heads, 1 kv head: on 1 x 2 each rank
  holds half of the kv head's columns, so k and v are gathered) and the
  same with 5 query heads (2.5 per rank: q gathered, padded to 6 heads,
  the outputs gathered before ``wo``): the serve step's logits on the
  schedule;
* reduced whisper-base (vocabulary 512, vocab-parallel) and the same with
  a vocabulary of 515 (whole on every rank, as 51865 is): the lock-step
  decode's logits, the source encoded on the ranks.

Held: the 1 x 2 logits within ``LOGIT_TOL`` of the reference's (1, 2)
step and of the port's one process (the tolerance of
``tests/test_torch_tp_families.py``); under ``fp32`` within 1e-5 of the
logits' scale of one process's; both ranks bitwise; recurrentgemma's
1 x 2 engine tokens against one process's (``TOKEN_AGREEMENT``, C18),
paged ≡ contiguous and 2 x 2 ≡ 1 x 2 (its sharded RG-LRU state under a
data axis); on 1 x 4 qwen2.5-3b (2 kv heads: each rank keeps the one its
query heads read; contiguous ≡ paged) and recurrentgemma with 5 query
heads (padded to 8) within ``LOGIT_TOL`` of one process; the collectives
per serve step; ``axes.gather_shards`` forward and backward against the
unsplit product; and ``launch.serve --model-parallel 2`` serving
recurrentgemma.
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
SPECS = ("recurrentgemma-2b", "recurrentgemma-2b:n_heads=5", "whisper-base",
         "whisper-base:vocab=515")
LOGIT_TOL = 0.125
TOKEN_AGREEMENT = 0.9

REF_SCRIPT = textwrap.dedent("""
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
    qa = QArith(policy)
    mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    named = lambda tree: jax.tree_util.tree_map(                     # noqa: E731
        lambda s: NamedSharding(mesh, s), tree,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    saved = {}
    for spec in sys.argv[3:]:
        cfg = W.configs(spec)[1]
        n = W.N_SLOTS
        params = R.init(cfg, jax.random.PRNGKey(0), policy.param_dtype)
        params = jax.device_put(params, named(PT.param_specs(params, cfg, mesh)))
        logits = []
        with mesh, activation_sharding(("data",), 1, "model", 2):
            if cfg.encdec:
                src = jnp.asarray(W.src_embeds(cfg.d_model))
                cache = R.make_cache(qa, params, cfg, {"src_embeds": src}, batch_size=n,
                                     max_len=W.MAX_LEN)
                step = jax.jit(lambda p, c, t, pos: R.decode(qa, p, cfg, t, c, pos))
                for t, row in enumerate(W.schedule(cfg.vocab)):
                    lg, cache = step(params, cache, jnp.asarray(row)[:, None], jnp.int32(t))
                    logits.append(np.asarray(lg[:, -1], np.float32))
            else:
                step = jax.jit(make_serve_step(cfg, policy, return_logits=True))
                cache = R.make_cache(qa, params, cfg, {}, batch_size=n, max_len=W.MAX_LEN,
                                     dtype=policy.compute_dtype)
                cache = jax.device_put(cache, named(PT.cache_specs(cache, cfg, mesh)))
                for t, row in enumerate(W.schedule(cfg.vocab)):
                    _, lg, cache = step(params, cache, jnp.asarray(row)[:, None],
                                        jnp.full((n,), t, jnp.int32), jnp.ones((n,), bool),
                                        jnp.full((n,), t == 0))
                    logits.append(np.asarray(lg))
        saved[spec] = np.stack(logits)
    np.savez(out + "/ref.npz", **saved)
""")


def _serve_launch(log_dir: Path) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "repro_torch.launch.dist_launch", "-n", "2", "--timeout",
           str(TIMEOUT - 10), "--log-dir", str(log_dir), "--", sys.executable, "-m",
           "repro_torch.launch.serve", "--arch", "recurrentgemma-2b", "--reduced", "--device",
           "cpu", "--data-parallel", "1", "--model-parallel", "2", "--requests", "4"]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=rank_env(), cwd=ROOT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the launcher beside the port's 4-rank
    launch, then the 2-rank one."""
    out = tmp_path_factory.mktemp("tp_hybrid")
    flags = ("--xla_force_host_platform_device_count=2 --xla_allow_excess_precision=false "
             "--xla_cpu_multi_thread_eigen=false")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(out), str(Path(WORKER).parent),
                            *SPECS], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                           env=rank_env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu"), cwd=ROOT)
    launcher = _serve_launch(out / "launch")
    rank_kw = dict(env=rank_env(JAX_PLATFORMS="cpu"))
    try:
        run_ranks(WORKER, ["hybrid_quad", str(out)], 4, out / "quad_logs", TIMEOUT, **rank_kw)
        run_ranks(WORKER, ["hybrid", str(out), *SPECS], 2, out / "pair_logs", TIMEOUT,
                  **rank_kw)
        log, _ = ref.communicate(timeout=TIMEOUT)
        served = launcher.communicate(timeout=TIMEOUT)[0]
        log0 = out / "launch" / "rank0.log"
        served = (served + (log0.read_text() if log0.exists() else ""), launcher.returncode)
    finally:
        for p in (ref, launcher):
            if p.poll() is None:
                p.kill()
    assert ref.returncode == 0, log[-4000:]
    load = lambda name: [torch.load(out / f"rank{r}_{name}.pt", weights_only=False)  # noqa: E731
                         for r in range(2 if not name.endswith("quad") else 4)]
    pair = {s: load(f"hybrid_{s}") for s in SPECS}
    return (dict(np.load(out / "ref.npz")), pair, load("hybrid_quad"), load("hybrid_gather"),
            served)


def _tokens(d: dict) -> dict:
    return {k: np.asarray(v) for k, v in d.items() if isinstance(k, int)}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[r], b[r]) for r in a)


@pytest.mark.parametrize("spec", SPECS)
def test_logits_match_the_reference_on_a_model_axis(runs, spec):
    ref, pair, *_ = runs
    for res in pair[spec]:
        assert res["tp_schedule"].shape == ref[spec].shape
        assert np.abs(res["tp_schedule"] - ref[spec]).max() <= LOGIT_TOL
        assert np.abs(res["tp_schedule"] - res["one_schedule"]).max() <= LOGIT_TOL
    assert np.array_equal(pair[spec][0]["tp_schedule"], pair[spec][1]["tp_schedule"])


@pytest.mark.parametrize("spec", SPECS)
def test_fp32_model_axis_is_one_process_within_f32_rounding(runs, spec):
    _, pair, *_ = runs
    tp, one = pair[spec][0]["fp32_schedule"]
    assert tp.shape == one.shape
    assert np.abs(tp - one).max() <= 1e-5 * np.abs(one).max()


def test_engine_tokens_paged_and_two_by_two(runs):
    """recurrentgemma's 1 x 2 engine against one process's (C18), both
    ranks bitwise, paged ≡ contiguous, and 2 x 2 ≡ 1 x 2: each data rank
    holds its slots' RG-LRU state of its model rank's channels."""
    _, pair, quad, *_ = runs
    a, b = pair["recurrentgemma-2b"]
    tp, one = _tokens(a["tp"]), _tokens(a["one"])
    same = sum(int((tp[r] == one[r]).sum()) for r in tp)
    total = sum(one[r].size for r in one)
    assert total == sum(W.GENS) and same >= TOKEN_AGREEMENT * total, (same, total)
    for key in ("tp", "tp_paged", "one"):
        assert _equal(_tokens(a[key]), _tokens(b[key])), key
    assert _equal(_tokens(a["tp_paged"]), tp)
    assert sorted((r["coords"]["data"], r["coords"]["model"]) for r in quad) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for res in quad:
        assert _equal(_tokens(res["rg_tokens"]), tp)


@pytest.mark.parametrize("spec", ["qwen2.5-3b", "recurrentgemma-2b:n_heads=5"])
def test_four_ranks_against_one_process(runs, spec):
    """1 x 4: qwen2.5-3b's 2 kv heads (each rank keeps the one its query
    head reads) and recurrentgemma's 5 query heads (padded to 8, 2 per
    rank, the last rank's two all padding): the schedule's logits within
    ``LOGIT_TOL`` of one process's, every rank bitwise."""
    _, _, quad, *_ = runs
    for res in quad:
        assert np.array_equal(res[spec]["tp_schedule"], quad[0][spec]["tp_schedule"])
        assert np.abs(res[spec]["tp_schedule"] - res[spec]["one_schedule"]).max() <= LOGIT_TOL


def test_qwen_four_ranks_paged_equals_contiguous(runs):
    _, _, quad, *_ = runs
    tp, one = _tokens(quad[0]["qwen_tp"]), _tokens(quad[0]["qwen_one"])
    same = sum(int((tp[r] == one[r]).sum()) for r in tp)
    assert same >= TOKEN_AGREEMENT * sum(one[r].size for r in one)
    for res in quad:
        assert _equal(_tokens(res["qwen_paged"]), tp) and _equal(_tokens(res["qwen_tp"]), tp)


@pytest.mark.parametrize("spec", SPECS)
def test_collectives_per_serve_step(runs, spec):
    """Per RG-LRU block the ``xs`` gather, ``out`` and ``w_down``; per
    local-attention block the k/v gather (one for both), ``wo`` and
    ``w_down``, and with 5 query heads the q and output gathers; then the
    embedding and the logits. Whisper's decoder: self ``wo``, cross
    ``wo`` and ``w_down`` per layer, and the vocab-parallel embedding and
    logits where the axis divides the vocabulary (none when it does not),
    after the encoding's ``wo`` and ``w_down`` per encoder layer."""
    _, pair, *_ = runs
    cfg = W.configs(spec)[0]
    once = 0
    if cfg.encdec:
        want = 3 * cfg.n_layers + (2 if cfg.vocab % 2 == 0 else 0)
        once = 2 * cfg.n_enc_layers
    else:
        n_rec = sum(k == "rec" for k in cfg.block_pattern)
        n_attn = len(cfg.block_pattern) - n_rec
        want = 3 * n_rec + (3 + 2 * (cfg.n_heads % 2)) * n_attn + 2
    assert pair[spec][0]["schedule_calls"] == once + W.SCHEDULE_STEPS * want


@pytest.mark.parametrize("rank", [0, 1])
def test_gather_shards_matches_the_unsplit_product(runs, rank):
    *_, gather, _ = runs
    res = gather[rank]
    assert res["calls"] == 2          # one forward, one backward: both tensors at once
    for got, want in zip(res["fwd"], res["want"]):
        assert torch.equal(got, want)
    for got, want in zip(res["grad"], res["want_grad"]):
        # the ranks' cotangents are summed in f32 (then the f64 product)
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)


def test_launcher_serves_recurrentgemma_on_the_model_axis(runs):
    *_, (log, rc) = runs
    assert rc == 0, log[-3000:]
    assert "[serve] 4/4 finished" in log
