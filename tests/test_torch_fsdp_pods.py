"""The hierarchical pod-over-data composition on 4 gloo ranks, on the CPU:
the reference's cases of ``tests/test_transport.py::test_two_pod_wires_match_single_device``
with the model axis at 1 (the model axis's pods cases:
``tests/test_torch_dist_sweep.py``'s ``grad_wire`` run).

* pods 2 × data 2 with the fp32 pod wire and with the bf16 compressed wire;
* pods 2 × fsdp 2 with the bf16 wire over the FSDP inner (the
  reduce-scatter within each pod, the wire across pods on the shards),
  ``grad_accum`` 2.

Each case takes one ``bf16_sr_kahan`` AdamW step from the weights a
1-process step starts from, on the same batch; the parameters land within
the reference's 0.05 of the 1-process step's (the collectives reorder f32
sums and the SR draws differ). The residual rows sit on the pod axis: the
ranks of one pod (data or fsdp coordinates apart) hold the same row (under
FSDP the same row's shards, which gather into the row), the two pods'
rows differ, and the gathered stack has one row per pod. Each data-parallel
axis is reduced once: with pods × data the wire moves the bf16 payload and
the data mean an f32 one, per element once each.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.policy import get_policy
from repro_torch.data.synthetic import lm_batches
from repro_torch.models import registry as R
from repro_torch.optim import adamw, constant
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import make_train_state
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(Path(__file__).resolve().parent / "_torch_fsdp_worker.py")
TIMEOUT = 240
CASES = ["fp32", "compressed", "hier"]


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp_pods")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dist_launch", "-n", "4", "--timeout",
         str(TIMEOUT - 10), "--", sys.executable, WORKER, "pods", str(out)],
        capture_output=True, text=True, timeout=TIMEOUT, env=env, cwd=ROOT)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    return [torch.load(out / f"rank{r}_pods.pt") for r in range(4)]


@pytest.fixture(scope="module")
def single():
    """The 1-process step's parameters."""
    torch.set_num_threads(1)
    policy = get_policy("bf16_sr_kahan")
    cfg = R.get_config("qwen2.5-3b").reduced()
    opt = adamw(policy, b2=0.997)
    state = make_train_state(R.init(cfg, 0, policy.param_dtype, device="cpu"), opt)
    step = make_train_step(cfg, policy, opt, constant(1e-3), attn_chunk=8)
    state, _ = step(state, next(lm_batches(cfg.vocab, 8, 16, seed=1, device="cpu")), 0)
    return tree_leaves(state.params)


@pytest.mark.parametrize("case", CASES)
def test_pod_case_matches_single_process_step(pods, single, case):
    got = pods[0][case]["params"]
    assert len(got) == len(single)
    d = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, single))
    assert d < 0.05, (case, d)
    # every rank reports the same loss (the mean over all four)
    assert len({r[case]["loss"] for r in pods}) == 1


@pytest.mark.parametrize("case", ["compressed", "hier"])
def test_residual_rows_sit_on_the_pod_axis(pods, case):
    res = [r[case] for r in pods]
    assert all(r["wire_axis"] == "pod" and r["replicas"] == 2 for r in res)
    inner = "fsdp" if case == "hier" else "data"
    by = {(r["coords"]["pod"], r["coords"][inner]): r["rows"] for r in res}
    for p in range(2):
        for row in by[(p, 0)]:
            assert row.shape[0] == 1
    if case == "compressed":
        # the data replicas of a pod hold the same row
        for p in range(2):
            assert all(torch.equal(a, b) for a, b in zip(by[(p, 0)], by[(p, 1)]))
    else:
        # each rank its shard of its pod's row: half the leaf along the
        # parameter's FSDP dim
        assert any(a.shape != b.shape for a, b in zip(by[(0, 0)], pods[0]["fp32"]["params"]))
    # the pods' rows differ
    assert not all(torch.equal(a, b) for a, b in zip(by[(0, 0)], by[(1, 0)]))
    assert any(float(r.abs().max()) > 0 for r in by[(0, 0)])


def test_each_axis_reduced_once(pods):
    n = sum(t.numel() for t in pods[0]["fp32"]["params"])
    for r in pods:
        # pods x data, bf16 wire: the data mean in f32, then the wire in bf16
        assert r["compressed"]["stats"] == {"float32": 4 * n, "bfloat16": 2 * n}
        # the fp32 wire: the data mean, then the pod mean, both f32
        assert r["fp32"]["stats"] == {"float32": 8 * n}
