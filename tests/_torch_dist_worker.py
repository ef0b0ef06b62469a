"""One rank of the port's multi-process tests (tests/test_torch_dist*.py).

Run under ``python -m repro_torch.launch.dist_launch -n 2 -- python
tests/_torch_dist_worker.py SCENARIO OUT_DIR``: every rank joins the gloo
group from the ``REPRO_*`` triple, runs SCENARIO on the reduced qwen2.5-3b
on the CPU, and writes what the test compares to ``OUT_DIR/rank<r>*.pt``.
Imports torch and the port only.

* ``ref`` — one gradient phase per case of ``CASES`` from the reference's
  initial state (``OUT_DIR/init``, the reference's checkpoint), on its
  batch and with its wire bits (``OUT_DIR/ref.npz``): the reduced
  gradients, loss, gradient norm and this rank's new residual row.
* ``equal`` — 3 steps of the bf16 wire (fused AdamW, ``bf16_sr_kahan``,
  ``grad_accum`` 2, the default keys): every leaf of the state and the
  metrics.
* ``agree`` — the restore step broadcast from process 0 (each rank
  offers its own directory), then a run in which rank 1 alone is
  SIGTERMed at step 2: both ranks stop at the same step with one
  checkpoint.
* ``fault`` — rank 1's gradient phase fails at step 1 on every attempt;
  the rank raises, and its peer's collective fails with it.
"""
from __future__ import annotations

import os
import signal
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.policy import get_policy
from repro_torch.data.synthetic import lm_batches
from repro_torch.dist import multihost as MH
from repro_torch.dist import transport as T
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import registry as R
from repro_torch.optim import GivenKey, adamw, constant, fused_adamw_optimizer
from repro_torch.train import checkpoint as C
from repro_torch.train import loop as L
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import make_train_state
from repro_torch.tree import tree_leaves

POLICY = get_policy("bf16_sr_kahan")
REF_POLICY = get_policy("fp32")     # the policy of the reference comparison
CFG = R.get_config("qwen2.5-3b").reduced()
# (name, mesh kwargs, wire, grad_accum)
CASES = [("fp32_pod", dict(pods=2), "fp32", 1), ("bf16_pod", dict(pods=2), "bf16", 1),
         ("fp32_pod_accum2", dict(pods=2), "fp32", 2),
         ("bf16_pod_accum2", dict(pods=2), "bf16", 2),
         ("fp32_data", dict(data=2), "fp32", 1), ("bf16_data", dict(data=2), "bf16", 1)]
CHUNK = 8


def _run(mesh_kw, wire, accum, opt, *, bits=None, policy=POLICY):
    """(transport, step) of one case; ``bits``: the wire's given bits."""
    mesh = make_local_mesh(**mesh_kw)
    tr = T.make_transport(mesh=mesh, wire=wire)
    kw = {} if bits is None else dict(keys=lambda seed, step, replica: (None, bits))
    step = make_train_step(CFG, policy, opt, constant(1e-3), attn_chunk=CHUNK, transport=tr,
                           mesh=mesh, grad_accum=accum, **kw)
    return tr, step


def scenario_ref(out: Path, rank: int):
    ref = np.load(out / "ref.npz")
    batch = {k: torch.from_numpy(ref[k].astype(np.int32)) for k in ("tokens", "labels")}
    opt = adamw(REF_POLICY, b2=0.997)
    params = R.init(CFG, 0, REF_POLICY.param_dtype, device="cpu")
    n_leaves = len(tree_leaves(params))
    for name, mesh_kw, wire, accum in CASES:
        # the replica's index on the wire axis: the rank (one axis above 1)
        bits = (GivenKey([torch.from_numpy(ref[f"{name}_bits{rank}_{i}"].astype(np.int64))
                          for i in range(n_leaves)]) if wire != "fp32" else None)
        tr, step = _run(mesh_kw, wire, accum, opt, bits=bits, policy=REF_POLICY)
        state = make_train_state(params, opt, transport=tr)
        state, _ = C.restore(out / "init", state._replace(wire_residuals=None))
        state = state._replace(wire_residuals=tr.init_residuals(params))
        g = step.phases[0](state, batch, 0)
        torch.save({"grads": tree_leaves(g.grads), "loss": g.loss, "grad_norm": g.grad_norm,
                    "residuals": None if g.residuals is None else tree_leaves(g.residuals),
                    "replica": tr.replica, "stats": tr.stats.bytes_by_dtype},
                   out / f"rank{rank}_{name}.pt")


def scenario_equal(out: Path, rank: int):
    opt = fused_adamw_optimizer(POLICY, b2=0.997)
    params = R.init(CFG, 0, POLICY.param_dtype, device="cpu")
    # grad_accum 2: f32 gradients, so the bf16 wire drops bits into the
    # residuals (a bf16 gradient plus a zero residual rounds exactly)
    tr, step = _run(dict(data=2), "bf16", 2, opt)
    state = make_train_state(params, opt, transport=tr)
    metrics = []
    for i, batch in zip(range(3), lm_batches(CFG.vocab, 4, 16, seed=5, device="cpu")):
        state, m = step(state, batch, 0)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    torch.save({"leaves": C.flatten(state)[1:], "metrics": metrics, "step": state.step},
               out / f"rank{rank}_equal.pt")


def scenario_agree(out: Path, rank: int):
    # every rank offers its own directory; process 0's LATEST wins
    own = out / f"own{rank}"
    params = R.init(CFG, 0, POLICY.param_dtype, device="cpu")
    opt = adamw(POLICY, b2=0.997)
    bare = make_train_state(params, opt)
    C.save(own, 3 if rank == 0 else 1, bare)
    agreed = L._agreed_restore_step(C.CheckpointManager(own))
    tr, step = _run(dict(data=2), "bf16", 1, opt)
    state = make_train_state(params, opt, transport=tr)

    def hook(s):
        if rank == 1 and s == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    logs = []
    state, info = L.run_training(
        state, step, lambda s: lm_batches(CFG.vocab, 4, 16, seed=5, start_step=s,
                                          device="cpu"),
        L.TrainLoopConfig(total_steps=8, ckpt_dir=str(out / "ck"), ckpt_every=100,
                          preempt_poll_every=1, wire_format=tr.wire_format),
        log=logs.append, fault_hook=hook, transport=tr)
    torch.save({"agreed": agreed, "preempted": info["preempted"], "step": state.step,
                "logs": logs}, out / f"rank{rank}_agree.pt")


def scenario_fault(out: Path, rank: int):
    params = R.init(CFG, 0, POLICY.param_dtype, device="cpu")
    opt = adamw(POLICY, b2=0.997)
    tr, step = _run(dict(data=2), "bf16", 1, opt)
    state = make_train_state(params, opt, transport=tr)

    def hook(s):
        if rank == 1 and s == 1:
            raise RuntimeError("injected fault")

    logs = []
    try:
        L.run_training(state, step, lambda s: lm_batches(CFG.vocab, 4, 16, seed=5,
                                                         start_step=s, device="cpu"),
                       L.TrainLoopConfig(total_steps=4, ckpt_dir=str(out / "ck"),
                                         ckpt_every=1, max_retries_per_step=1),
                       log=logs.append, fault_hook=hook, transport=tr)
    finally:
        (out / f"rank{rank}_fault.log").write_text("\n".join(logs))


def main():
    scenario, out = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    MH.initialize(device="cpu", timeout_secs=float(os.environ.get("WORKER_TIMEOUT", 60)))
    try:
        globals()[f"scenario_{scenario}"](out, MH.process_index())
    finally:
        MH.shutdown()


if __name__ == "__main__":
    main()
