"""Ranks of tests/test_torch_tp_train.py and tests/test_torch_tp_families_train.py:
reduced configs (qwen2.5-3b, or the archs a scenario is given) trained on
``(data, model)`` meshes of gloo ranks.

    python -m repro_torch.launch.dist_launch -n 4 -- python tests/_torch_tp_train_worker.py quad OUT
    python -m repro_torch.launch.dist_launch -n 2 -- python tests/_torch_tp_train_worker.py pair OUT
    python -m repro_torch.launch.dist_launch -n 2 -- python tests/_torch_tp_train_worker.py family OUT A...

``quad`` (4 ranks, 2 data x 2 model): ``QUAD_STEPS`` steps of the bf16
wire (fused AdamW on the shards, ``bf16_sr_kahan``), checkpointed at the
end into ``OUT/ck``. ``pair`` (2 ranks, 1 x 2), after the reference's
subprocess wrote ``OUT/ref.npz`` and its initial states ``OUT/init_<policy>``:
per policy of ``REF_POLICIES`` the 1 x 2 gradient phase and the
one-process one from the reference's weights, the non-fused SR update of
the shards against the one-process update, the backward from a thread
with no axis installed, ``vocab_parallel_xent`` on random logits, and
``quad``'s checkpoint restored under 1 x 2. ``family`` (2 ranks, 1 x 2)
runs the per-policy part for each arch A from ``OUT/ref_<A>.npz`` and
``OUT/init_<A>_<policy>``; A may be a config spec ``arch:field=N:...``
(:func:`configs`), and an encoder-decoder's batch carries its
``src_embeds``. Each rank saves what it saw to
``OUT/rank<r>_<scenario>[_<A>].pt``. Imports torch and the port only.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.policy import get_policy
from repro_torch.core.qarith import QArith
from repro_torch.data.synthetic import lm_batches
from repro_torch.dist import axes
from repro_torch.dist import fsdp as F
from repro_torch.dist import multihost as MH
from repro_torch.dist import partition as PT
from repro_torch.dist import transport as T
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import registry as R
from repro_torch.optim import adamw, constant, fused_adamw_optimizer
from repro_torch.train import checkpoint as C
from repro_torch.train import loop as L
from repro_torch.train.step import Gradients, _global_norm, compute_params, make_train_step
from repro_torch.train.train_state import make_train_state, softmax_xent
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

from _torch_ranks import config_overrides

CFG = R.get_config("qwen2.5-3b").reduced()
REF_POLICIES = ("fp32", "bf16_sr")
BATCH, SEQ, CHUNK = 4, 16, 8
QUAD_POLICY = "bf16_sr_kahan"
QUAD_STEPS = 2
# the random logits of the vocab-parallel loss's check: (B, S) positions,
# the first IGNORED of row 0 labelled -1
XENT_SHAPE, IGNORED = (2, 5), 2


def configs(spec: str):
    """The reduced config of ``spec``'s arch with its fields replaced (the
    reference's script replaces the same fields in its own config)."""
    arch, over = config_overrides(spec)
    return dataclasses.replace(R.get_config(arch).reduced(), **over)


def xent_inputs():
    g = torch.Generator().manual_seed(3)
    full = torch.randn((*XENT_SHAPE, CFG.vocab), generator=g) * 3
    labels = torch.randint(0, CFG.vocab, XENT_SHAPE, generator=g)
    labels[0, :IGNORED] = -1
    return full, labels


def _tp_state(params, opt, mesh, tr):
    """This rank's shards of ``params`` as a fresh state, and its specs."""
    state = make_train_state(F.shard_state(params, tr.pspecs, mesh), opt, transport=tr)
    return state, F.flat_specs(F.train_state_specs(state, tr.pspecs, tr))


def _full(local, spec, mesh):
    """A leaf whole on every rank of ``mesh``'s model group."""
    dims = F.sharded_dims(spec)
    if not dims:
        return local
    (dim, axis), = dims
    return torch.cat(axes._gather(local.contiguous(), axes.for_mesh(mesh)), dim=dim)


def _grads(params, qa, batch, axis, *, thread: bool):
    """Gradients of the remat forward's loss under ``axis``; with
    ``thread`` the backward runs on a new thread with no axis installed."""
    leaves = [w.detach().requires_grad_(True) for w in tree_leaves(params)]
    wc = tree_unflatten(params, leaves)
    with torch.enable_grad(), axes.model_axis(axis):
        loss = softmax_xent(R.forward_logits(qa, wc, CFG, batch, remat=True,
                                             attn_chunk=CHUNK), batch["labels"])
    if not thread:
        with axes.model_axis(axis):
            return torch.autograd.grad(loss, leaves)
    box = {}

    def run():
        assert axes.current() is None
        box["g"] = torch.autograd.grad(loss, leaves)
    t = threading.Thread(target=run)
    t.start()
    t.join()
    return box["g"]


def policy_runs(out: Path, cfg, batch, mesh, init: str) -> dict:
    """Per policy of ``REF_POLICIES``, from the reference's initial state
    ``OUT/<init>_<policy>``: the 1 x 2 gradient phase (this rank's and the
    gathered gradients, loss, norm) and the one-process one, and under a
    pure-bf16 SR policy the non-fused update of the shards and the
    one-process update's slices given the same gradients."""
    res = {}
    for name in REF_POLICIES:
        policy = get_policy(name)
        opt = adamw(policy, b2=0.997)
        like = R.init(cfg, 0, policy.param_dtype, device="cpu")
        one, _ = C.restore(out / f"{init}_{name}", make_train_state(like, opt))
        step1 = make_train_step(cfg, policy, opt, constant(1e-3), attn_chunk=CHUNK)
        g1 = step1.phases[0](one, batch, 0)
        pspecs = PT.param_specs(like, cfg, mesh)
        tr = T.make_transport(mesh=mesh, placement=PT.Placement(), pspecs=pspecs)
        tp, specs = _tp_state(like, opt, mesh, tr)
        tp, _ = C.restore(out / f"{init}_{name}", tp, specs=specs, mesh=mesh)
        step2 = make_train_step(cfg, policy, opt, constant(1e-3), attn_chunk=CHUNK,
                                transport=tr, mesh=mesh)
        g2 = step2.phases[0](tp, batch, 0)
        pflat = tree_leaves(pspecs)
        full = [_full(g, s, mesh) for g, s in zip(tree_leaves(g2.grads), pflat)]
        res[name] = {"local": tree_leaves(g2.grads), "full": full, "loss": g2.loss,
                     "norm": g2.grad_norm, "one": tree_leaves(g1.grads), "one_loss": g1.loss,
                     "one_norm": g1.grad_norm, "paths": tree_paths(like),
                     "norm_of_full": _global_norm(full), "specs": [tuple(x) for x in pflat]}
        if policy.update_rounding == "stochastic" and not policy.master_weights:
            # the non-fused SR update of the shards against the one-process
            # update given the same (gathered) gradients
            g_full = Gradients(tree_unflatten(one.params, full), g2.loss, g2.grad_norm)
            one_new, _ = step1.phases[1](one, g_full, 0)
            tp_new, _ = step2.phases[1](tp, g2, 0)
            res[name]["update"] = {
                "shards": tree_leaves(tp_new.params),
                "slices": [F.local_slice(w, s, mesh) for w, s in
                           zip(tree_leaves(one_new.params), pflat)],
                "moments": [F.local_slice(w, s, mesh) for w, s in
                            zip(tree_leaves(one_new.opt_state.m), pflat)],
                "shard_moments": tree_leaves(tp_new.opt_state.m)}
    return res


def scenario_pair(out: Path, rank: int):
    ref = np.load(out / "ref.npz")
    batch = {k: torch.from_numpy(ref[k].astype(np.int32)) for k in ("tokens", "labels")}
    mesh = make_local_mesh(1, 2)
    axis = axes.for_mesh(mesh)
    res = {"coords": mesh.coords(rank)}
    res.update(policy_runs(out, CFG, batch, mesh, "init"))
    # the backward from a thread with no axis installed (the remat recompute
    # included) == the backward on this thread under the axis
    policy = get_policy("bf16_sr")
    like = R.init(CFG, 0, policy.param_dtype, device="cpu")
    local = F.shard_state(like, PT.param_specs(like, CFG, mesh), mesh)
    wc = compute_params(local, policy)
    qa = QArith(policy)
    res["thread"] = [_grads(wc, qa, batch, axis, thread=t) for t in (False, True)]
    # the vocab-parallel loss on random logits, ignore labels included
    full, labels = xent_inputs()
    width = CFG.vocab // 2
    logits = full.narrow(-1, rank * width, width).clone().requires_grad_(True)
    with axes.model_axis(axis):
        loss = axes.vocab_parallel_xent(logits, labels)
    loss.backward()
    res["xent"] = {"loss": loss.detach(), "grad": logits.grad, "calls": axis.stats.calls}
    # quad's 2 x 2 checkpoint restored under 1 x 2 (one wire replica: the
    # residuals restart from zero)
    policy = get_policy(QUAD_POLICY)
    opt = fused_adamw_optimizer(policy, b2=0.997, mesh=mesh,
                                pspecs=PT.param_specs(like, CFG, mesh))
    tr = T.make_transport(mesh=mesh, placement=PT.Placement(),
                          pspecs=PT.param_specs(like, CFG, mesh), wire="bf16")
    state, specs = _tp_state(R.init(CFG, 0, policy.param_dtype, device="cpu"), opt, mesh, tr)
    state, at = L._restore(C.CheckpointManager(out / "ck", mesh=mesh), state, print,
                           wire_format=tr.wire_format, transport=tr,
                           specs=F.train_state_specs(state, tr.pspecs, tr))
    res["restored"] = {"step": at, "leaves": C.flatten(state)[1:],
                       "specs": [tuple(x) for x in specs[1:]]}
    torch.save(res, out / f"rank{rank}_pair.pt")


def scenario_family(out: Path, rank: int, *archs: str):
    """``policy_runs`` for each arch from ``OUT/ref_<arch>.npz`` and its
    initial states ``OUT/init_<arch>_<policy>``."""
    mesh = make_local_mesh(1, 2)
    for arch in archs:
        cfg = configs(arch)
        ref = np.load(out / f"ref_{arch}.npz")
        batch = {k: torch.from_numpy(ref[k].astype(np.int32)) for k in ("tokens", "labels")}
        if "src_embeds" in ref:
            batch["src_embeds"] = torch.from_numpy(ref["src_embeds"])
        res = {"coords": mesh.coords(rank)}
        res.update(policy_runs(out, cfg, batch, mesh, f"init_{arch}"))
        torch.save(res, out / f"rank{rank}_family_{arch}.pt")


def scenario_quad(out: Path, rank: int):
    policy = get_policy(QUAD_POLICY)
    mesh = make_local_mesh(2, 2)
    params = R.init(CFG, 0, policy.param_dtype, device="cpu")
    pspecs = PT.param_specs(params, CFG, mesh)
    opt = fused_adamw_optimizer(policy, b2=0.997, mesh=mesh, pspecs=pspecs)
    tr = T.make_transport(mesh=mesh, placement=PT.Placement(), pspecs=pspecs, wire="bf16")
    state, specs = _tp_state(params, opt, mesh, tr)
    step = make_train_step(CFG, policy, opt, constant(1e-3), attn_chunk=CHUNK, transport=tr,
                           mesh=mesh, grad_accum=2)
    logs = []
    state, info = L.run_training(
        state, step, lambda s: lm_batches(CFG.vocab, BATCH, SEQ, seed=5, start_step=s,
                                          device="cpu"),
        L.TrainLoopConfig(total_steps=QUAD_STEPS, ckpt_dir=str(out / "ck"),
                          ckpt_every=QUAD_STEPS, wire_format=tr.wire_format),
        log=logs.append, transport=tr)
    torch.save({"coords": mesh.coords(rank), "leaves": C.flatten(state)[1:],
                "specs": [tuple(x) for x in specs[1:]],
                "n_params": len(tree_leaves(state.params)),
                "losses": [h["loss"] for h in info["history"]],
                "stats": dict(tr.stats.bytes_by_dtype),
                "local_numel": sum(t.numel() for t in tree_leaves(state.params))},
               out / f"rank{rank}_quad.pt")


def main():
    scenario, out = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    MH.initialize(device="cpu", timeout_secs=float(os.environ.get("WORKER_TIMEOUT", 120)))
    try:
        globals()[f"scenario_{scenario}"](out, MH.process_index(), *sys.argv[3:])
    finally:
        MH.shutdown()


if __name__ == "__main__":
    main()
