"""One rank of the port's FSDP tests (tests/test_torch_fsdp*.py).

Run under ``python -m repro_torch.launch.dist_launch -n N -- python
tests/_torch_fsdp_worker.py SCENARIO OUT_DIR``: every rank joins the gloo
group from the ``REPRO_*`` triple, runs SCENARIO on the reduced qwen2.5-3b
on the CPU, and writes what the test compares to ``OUT_DIR/rank<r>_*.pt``.
Imports torch and the port only.

* ``ref`` (2 ranks, ``--fsdp-parallel 2``) — from the reference's initial
  state (``OUT_DIR/init``, restored into this rank's shards) and batch
  (``OUT_DIR/ref.npz``) one gradient phase under ``fp32``: the reduced
  gradient shards, loss, gradient norm and what the collectives moved; then
  the shard-local fused AdamW update of the reference's random bf16 state
  with the reference's folded per-shard bits (``GivenKey``).
* ``invariants`` (2 ranks) — 3 non-fused ``bf16_sr_kahan`` steps under
  FSDP-2 and under DP-2 from one start, every FSDP leaf gathered (process
  0 holds both); 2 fused steps under FSDP-2 (this rank's shards); the
  gather bytes of one step at ``grad_accum`` 1 and 4; the state bytes per
  rank under each placement.
* ``ckpt`` (2 ranks) — an FSDP-2 run through the one-replica bf16 wire
  (``grad_accum`` 2: its residual shards move) for 4 steps; the same with
  rank 1 alone SIGTERMed at step 1 (checkpoint at step 2), then resumed by
  a fresh state to step 4; the step-2 checkpoint restored under DP-2; a
  DP-2 checkpoint and the reference's (``OUT_DIR/jref``) restored under
  FSDP-2; an fp32 DP-2 run with checkpoints, counting each rank's commits.
* ``pods`` (4 ranks) — one step of each of the reference's pod cases
  (pods 2 x data 2 fp32 and bf16; pods 2 x fsdp 2 bf16, ``grad_accum`` 2):
  the gathered parameters, this rank's residual rows and its coordinates.
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
from repro_torch.dist import fsdp as F
from repro_torch.dist import multihost as MH
from repro_torch.dist import partition as PT
from repro_torch.dist import transport as T
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import registry as R
from repro_torch.optim import GivenKey, adamw, constant, fused_adamw_optimizer
from repro_torch.optim.adamw import AdamWState
from repro_torch.train import checkpoint as C
from repro_torch.train import loop as L
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import make_train_state
from repro_torch.tree import tree_leaves, tree_unflatten

POLICY = get_policy("bf16_sr_kahan")
CFG = R.get_config("qwen2.5-3b").reduced()
CHUNK = 8


def build(mesh_kw, *, fsdp: bool, wire: str = "fp32", accum: int = 1, opt=None,
          policy=POLICY, keys=None):
    """(mesh, transport, pspecs, state on this rank, step) of one run."""
    mesh = make_local_mesh(**mesh_kw)
    placement = PT.default_placement(mesh, fsdp=fsdp)
    params = R.init(CFG, 0, policy.param_dtype, device="cpu")
    pspecs = PT.param_specs(params, CFG, mesh, placement)
    params = F.shard_state(params, pspecs, mesh)
    opt = opt or adamw(policy, b2=0.997)
    tr = T.make_transport(mesh=mesh, placement=placement, pspecs=pspecs, wire=wire)
    kw = {} if keys is None else dict(keys=keys)
    step = make_train_step(CFG, policy, opt, constant(1e-3), attn_chunk=CHUNK, transport=tr,
                           mesh=mesh, grad_accum=accum, **kw)
    return mesh, tr, pspecs, make_train_state(params, opt, transport=tr), step


def batches(start=0, batch=4):
    return lm_batches(CFG.vocab, batch, 16, seed=5, start_step=start, device="cpu")


def gathered(state, tr, mesh):
    """Every leaf of ``state`` whole (process 0; None elsewhere)."""
    specs = F.flat_specs(F.train_state_specs(state, tr.pspecs, tr))
    return [F.gather_full(t, s, mesh) if isinstance(t, torch.Tensor) else t
            for t, s in zip(C.flatten(state), specs)]


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def scenario_ref(out: Path, rank: int):
    ref = np.load(out / "ref.npz")
    batch = {k: torch.from_numpy(ref[k].astype(np.int32)) for k in ("tokens", "labels")}
    fp32 = get_policy("fp32")
    opt = adamw(fp32, b2=0.997)
    mesh, tr, pspecs, state, step = build(dict(fsdp=2), fsdp=True, opt=opt, policy=fp32)
    specs = F.train_state_specs(state, pspecs, tr)
    state, _ = C.restore(out / "init", state, specs=F.flat_specs(specs), mesh=mesh)
    g = step.phases[0](state, batch, 0)
    torch.save({"grads": tree_leaves(g.grads), "loss": g.loss, "grad_norm": g.grad_norm,
                "index": mesh.index("fsdp"), "stats": tr.stats.bytes_by_dtype,
                "scatter": tr.stats.scatter_bytes,
                "gather": tr.stats.gather_bytes_by_dtype}, out / f"rank{rank}_grads.pt")
    # the fused update on this rank's shards, with the reference's bits
    policy = POLICY
    params = R.init(CFG, 0, policy.param_dtype, device="cpu")
    n = len(tree_leaves(params))
    full = {name: tree_unflatten(params, [_bf16(ref[f"in_{name}_{i}"]) for i in range(n)])
            for name in "wgmvc"}
    sh = {name: F.shard_state(t, pspecs, mesh) for name, t in full.items()}
    fopt = fused_adamw_optimizer(policy, b2=0.997, mesh=mesh, pspecs=pspecs)
    one = torch.ones((), dtype=torch.bfloat16)
    ostate = AdamWState(sh["m"], sh["v"], one, one.clone(), sh["c"])
    bits = GivenKey([torch.from_numpy(ref[f"bits{rank}_{i}"].astype(np.int64))
                     for i in range(n)])
    new_w, new_s = fopt.update(sh["g"], ostate, sh["w"], step=0, key=bits, lr=1e-3)
    torch.save({"w": tree_leaves(new_w), "m": tree_leaves(new_s.m), "v": tree_leaves(new_s.v),
                "c": tree_leaves(new_s.kahan_c)}, out / f"rank{rank}_fused.pt")


def scenario_invariants(out: Path, rank: int):
    res = {}
    for tag, mesh_kw, fsdp in (("fsdp", dict(fsdp=2), True), ("dp", dict(data=2), False)):
        mesh, tr, pspecs, state, step = build(mesh_kw, fsdp=fsdp)
        res[f"{tag}_bytes"] = F.per_device_bytes((state.params, state.opt_state))
        metrics = []
        for _, b in zip(range(3), batches()):
            state, m = step(state, b, 0)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        res[f"{tag}_metrics"] = metrics
        res[f"{tag}_leaves"] = gathered(state, tr, mesh)[1:]
        if fsdp:
            res["specs"] = [tuple(s) for s in F.flat_specs(F.train_state_specs(state, pspecs,
                                                                               tr))][1:]
            res["fsdp_local"] = C.flatten(state)[1:]
    # fused, shard-local: the replicated leaves must stay equal on both ranks
    mesh = make_local_mesh(fsdp=2)
    placement = PT.default_placement(mesh, fsdp=True)
    pspecs = PT.param_specs(R.init(CFG, 0, torch.bfloat16, device="cpu"), CFG, mesh,
                            placement)
    opt = fused_adamw_optimizer(POLICY, b2=0.997, mesh=mesh, pspecs=pspecs)
    mesh, tr, pspecs, state, step = build(dict(fsdp=2), fsdp=True, opt=opt)
    for _, b in zip(range(2), batches()):
        state, _ = step(state, b, 0)
    res["fused_local"] = C.flatten(state)[1:]
    res["fused_leaves"] = gathered(state, tr, mesh)[1:]
    # gather bytes per step: flat in grad_accum (one gather per step)
    for k in (1, 4):
        mesh, tr, pspecs, state, step = build(dict(fsdp=2), fsdp=True, accum=k)
        step(state, next(batches(batch=8)), 0)
        res[f"gather_accum{k}"] = dict(tr.stats.gather_bytes_by_dtype)
        res[f"scatter_accum{k}"] = tr.stats.scatter_bytes
    torch.save(res, out / f"rank{rank}_invariants.pt")


def _commits():
    """Count this process's checkpoint commits."""
    count = [0]
    orig = C._commit

    def counting(*a, **kw):
        count[0] += 1
        return orig(*a, **kw)

    C._commit = counting
    return count


def scenario_ckpt(out: Path, rank: int):
    res = {}
    cfg = dict(fsdp=2)

    def run(ck=None, sigterm_at=None, steps=4, *, mesh_kw=cfg, fsdp=True, wire="bf16",
            accum=2):
        mesh, tr, pspecs, state, step = build(mesh_kw, fsdp=fsdp, wire=wire, accum=accum)

        def hook(s):
            if rank == 1 and s == sigterm_at:
                os.kill(os.getpid(), signal.SIGTERM)

        state, info = L.run_training(
            state, step, batches, L.TrainLoopConfig(
                total_steps=steps, ckpt_dir=None if ck is None else str(ck), ckpt_every=2,
                preempt_poll_every=1, wire_format=getattr(tr, "wire_format", None)),
            log=lambda *_: None, fault_hook=hook, transport=tr)
        return state, info, tr, mesh

    state, info, tr, mesh = run()
    res["whole"] = C.flatten(state)[1:]
    res["whole_losses"] = [r["loss"] for r in info["history"]]
    state, info, tr, mesh = run(out / "ck", sigterm_at=1)
    res["stop"] = (info["preempted"], state.step, [r["loss"] for r in info["history"]])
    MH.barrier("stopped")
    state, info, tr, mesh = run(out / "ck")
    res["resumed"] = C.flatten(state)[1:]
    res["resumed_losses"] = [r["loss"] for r in info["history"]]
    # the step-2 checkpoint (FSDP-2) under DP-2: the stored leaves whole
    mesh, tr, pspecs, state, step = build(dict(data=2), fsdp=False, wire="bf16", accum=2)
    state, _ = L._restore(C.CheckpointManager(out / "ck", mesh=mesh), state, print, step=2,
                          wire_format="bf16", transport=tr,
                          specs=F.train_state_specs(state, pspecs, tr))
    res["dp_restored"] = C.flatten(state)[1:]
    # a DP-2 checkpoint and the reference's under FSDP-2: this rank's shards
    state, _, _, _ = run(out / "ck_dp", steps=2, mesh_kw=dict(data=2), fsdp=False,
                         wire="fp32", accum=1)
    for name in ("ck_dp", "jref"):
        mesh, tr, pspecs, state, step = build(cfg, fsdp=True)
        specs = F.train_state_specs(state, pspecs, tr)
        state, at = C.restore(out / name, state, specs=F.flat_specs(specs), mesh=mesh)
        res[f"{name}_shards"] = (at, C.flatten(state)[1:], [tuple(s) for s in
                                                            F.flat_specs(specs)][1:])
    # a stateless transport under 2 ranks: only process 0 commits
    count = _commits()
    run(out / "ck_fp32", steps=4, mesh_kw=dict(data=2), fsdp=False, wire="fp32", accum=1)
    res["commits"] = count[0]
    res["index"] = mesh.index("fsdp")
    torch.save(res, out / f"rank{rank}_ckpt.pt")


# (name, mesh kwargs, fsdp, wire, grad_accum): the reference's pod cases
POD_CASES = [("fp32", dict(pods=2, data=2), False, "fp32", 1),
             ("compressed", dict(pods=2, data=2), False, "bf16", 1),
             ("hier", dict(pods=2, fsdp=2), True, "bf16", 2)]


def scenario_pods(out: Path, rank: int):
    res = {}
    batch = next(lm_batches(CFG.vocab, 8, 16, seed=1, device="cpu"))
    for name, mesh_kw, fsdp, wire, accum in POD_CASES:
        mesh, tr, pspecs, state, step = build(mesh_kw, fsdp=fsdp, wire=wire, accum=accum)
        state, m = step(state, batch, 0)
        res[name] = {"params": gathered(state, tr, mesh)[1:1 + len(tree_leaves(state.params))],
                     "rows": None if state.wire_residuals is None
                     else tree_leaves(state.wire_residuals),
                     "coords": mesh.coords(rank), "replicas": tr.wire_replicas,
                     "wire_axis": tr.wire_axis, "loss": float(m["loss"]),
                     "stats": dict(tr.stats.bytes_by_dtype)}
    torch.save(res, out / f"rank{rank}_pods.pt")


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
