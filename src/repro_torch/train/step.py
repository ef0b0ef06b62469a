"""Train / eval / serve step builders (port of ``repro.train.step``).

``make_train_step`` returns ``(state, batch, seed) -> (state, metrics)``
closed over config, policy and optimizer. Precision flows per the paper:
forward/backward run in the policy's compute format (master-copy policies
cast a bf16 working copy of the weights for compute), gradients land in
the compute dtype and feed the quantized optimizer update (Algorithms
2–5), which writes the new weights and state in place. ``grad_accum=k``
runs k microbatches over one working copy, accumulating f32 gradients,
before one update on their mean.

Every gradient collective goes through a
:class:`repro_torch.dist.transport.GradientTransport`: on a mesh each rank
computes the rows the reference gives its device
(``dist/partition.py::rank_rows``), ``transport.prepare`` gathers an FSDP
working copy (once per step, outside the microbatch loop), and
``transport.reduce`` reduce-scatters over the FSDP axis, takes the step's
f32 mean over the other data-parallel axes (the mean the reference leaves
to GSPMD inside its backward) and the mean on the wire axis, in that
order. Under FSDP the optimizer then updates this rank's shards.

On a mesh with a ``model`` axis above 1 (tensor parallelism, Megatron's
split of :mod:`repro_torch.dist.axes`) the gradient phase runs under that
axis: each rank holds its shards of the column- and row-parallel kernels
and the vocab-parallel embedding (whole where the axis does not divide
the vocabulary), its forward and backward run the model group's
collectives, the loss is taken on its vocab columns (on the whole logits
of a whole head), and the gradients land on its shards, which the data
axes reduce as any leaf; a whole leaf's gradient is the same on every
rank and counts once in the norm.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.formats import round_nearest
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.qarith import QArith
from repro_torch.dist import axes
from repro_torch.dist import fsdp as F
from repro_torch.dist import partition as PT
from repro_torch.dist import transport as T
from repro_torch.kernels import dispatch
from repro_torch.models import registry as R
from repro_torch.optim.base import ShardKey, StepKey, write_back
from repro_torch.optim.grad_compress import WireKey, gather_parts, wire_mean
from repro_torch.serve import cache as SC
from repro_torch.train.train_state import TrainState, softmax_xent
from repro_torch.tree import (tree_leaves, tree_map, tree_paths, tree_pop_leaves,
                              tree_unflatten)

__all__ = ["Gradients", "compute_params", "step_keys", "make_train_step", "make_eval_step",
           "make_serve_step"]

PyTree = Any


def compute_params(params: PyTree, policy: PrecisionPolicy) -> PyTree:
    """Working copy of the weights in the compute format.

    * pure-16-bit policies: storage *is* the compute copy (no-op)
    * master-copy policies (fp32 / mixed / ablation): one RNE cast per tensor
    * simulated sub-16-bit: already grid-snapped f32, used as-is
    """
    if not policy.master_weights or policy.compute_format.name == "fp32":
        return params
    if policy.compute_format.name == "bf16":
        return tree_map(lambda w: w.to(torch.bfloat16), params)
    return tree_map(lambda w: round_nearest(w, policy.compute_format), params)


# the one leaf a batch may leave unreached: a vlm's embeddings batch skips it
_TOKEN_EMBEDDING = "embed.embedding"


def _batch_dim(name: str) -> int:
    """Batch dim of a batch leaf: 1 for ``mrope_positions`` ((3,B,S)),
    else 0 (reference ``_batch_dim``)."""
    return 1 if name == "mrope_positions" else 0


def _split_microbatches(batch: dict, k: int) -> list[dict]:
    """k microbatches along every leaf's batch dim."""
    for name, x in batch.items():
        if x.shape[_batch_dim(name)] % k:
            raise ValueError(f"global batch {x.shape[_batch_dim(name)]} of {name!r} not "
                             f"divisible by grad_accum={k}")
    return [{name: x.chunk(k, dim=_batch_dim(name))[i] for name, x in batch.items()}
            for i in range(k)]


class Gradients(NamedTuple):
    """What the gradient phase of a train step hands its update phase."""
    grads: PyTree               # reduced, shaped like the params
    loss: torch.Tensor          # f32, the mean over the data-parallel ranks
    grad_norm: torch.Tensor     # f32, of the reduced gradients
    residuals: PyTree | None = None     # the wire's new error-feedback rows


def step_keys(seed: int, step: int, replica: int) -> tuple:
    """The randomness of one step: the update's per-leaf SR streams
    (:class:`StepKey`, the same on every rank, so the replicas stay
    bitwise equal) and this replica's wire streams (:class:`WireKey`)."""
    return StepKey(seed, step), WireKey(seed, step, replica)


def make_train_step(cfg, policy: PrecisionPolicy, optimizer, lr_schedule, *,
                    remat: bool = True, attn_chunk: int = 1024,
                    loss_fn: Callable | None = None, pspecs=None, placement=None,
                    transport=None, grad_accum: int = 1, mesh=None,
                    keys: Callable = step_keys):
    """One train step: ``(state, batch, seed) -> (state, metrics)`` with
    metrics ``loss`` (f32 tensor), ``lr`` (float) and ``grad_norm``.

    ``batch`` is the family's batch dict on the parameters' device
    (``models/registry.py``): ``tokens`` and ``labels`` (B,S); a vlm's
    ``embeds`` and ``mrope_positions`` (3,B,S), split on dim 1 into
    microbatches; an encoder-decoder's ``src_embeds`` beside its target
    ``tokens``. The SR randomness of step ``state.step`` comes from
    ``StepKey(seed, state.step)``: one stream per parameter leaf. The
    params and optimizer state of ``state`` are updated in place and
    returned in the new state.

    The step is two phases, exposed as ``train_step.phases = (gradients,
    update)`` for :func:`repro_torch.train.loop.run_training`:
    ``gradients(state, batch, seed) -> Gradients`` reads the state and
    does not touch it, and ends in a read of the gradient norm (a sync),
    so a device fault of its kernels surfaces inside it; ``update(state,
    gradients, seed) -> (state, metrics)`` writes the new weights and
    optimizer state in place. ``train_step`` is ``update`` after
    ``gradients``.

    The gradient path belongs to ``transport``; without one it is derived
    from ``mesh``/``placement``/``pspecs`` (the f32 data-parallel mean; with
    an FSDP placement and its ``pspecs``, the reduce-scatter). Under FSDP
    ``state`` holds this rank's shards (:func:`repro_torch.dist.fsdp.shard_state`):
    the working copy is gathered once per step, the gradients land on the
    shards, the optimizer updates them (a non-fused SR write rounds a shard
    with its leaf's Philox words at the shard's positions, so the result
    equals the data-parallel update's bit for bit), and ``grad_norm`` sums
    the shards' squares over the FSDP group. On a ``model`` axis above 1
    ``state`` holds this rank's tensor-parallel shards (the transport's
    ``pspecs``), the gradient phase runs under :func:`repro_torch.dist.axes.model_axis`,
    and the SR writes and the norm treat the TP shards as FSDP's.
    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`; the transport's
    when not given) places this process: every rank is handed the same
    global batch and computes the rows of its replica, the loss is the mean
    over the ranks, and ``grad_norm`` is taken on the reduced gradients, so
    both are the same on every rank. The wire's reduce runs in the gradient
    phase; its new residuals are written into the state in the update
    phase. ``keys(seed, step, replica) -> (update key, wire key)`` gives a
    step's randomness (:func:`step_keys`; a test passes ``GivenKey`` s of
    the reference's bits).
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if transport is None:
        transport = T.make_transport(mesh=mesh, placement=placement, pspecs=pspecs)
    if mesh is None:
        mesh = transport.mesh
    split = mesh is not None and PT.dp_size(mesh) > 1
    # the mean the reference leaves to GSPMD: every data-parallel axis above
    # size 1 that neither the wire nor the FSDP reduce-scatter reduces
    mean_groups = ([] if mesh is None else
                   [mesh.group(a) for a in transport.hint_axes(mesh)[0] if mesh.shape[a] > 1])
    # the parameters' specs when they shard a leaf (FSDP, the model axis):
    # the update's shards and the norm's
    pspecs = getattr(transport, "pspecs", None) if mesh is not None else None
    shard_specs = (pspecs if pspecs is not None
                   and any(F.sharded_dims(s) for s in tree_leaves(pspecs)) else None)
    axis = axes.for_mesh(mesh)
    qa = QArith(policy)

    def within(grads):
        for group in mean_groups:
            flat = tree_pop_leaves(grads)
            for i in range(len(flat)):
                flat[i] = wire_mean(flat[i].to(torch.float32), group, transport.stats,
                                    kind="mean")
            grads = tree_unflatten(grads, flat)
        return grads

    def _loss(wc, batch):
        logits = R.forward_logits(qa, wc, cfg, batch, remat=remat, attn_chunk=attn_chunk)
        if loss_fn is not None:
            return loss_fn(logits, batch)
        return softmax_xent(logits, batch["labels"], vocab=cfg.vocab)

    def _micro_grads(wc, leaves, paths, batch):
        with torch.enable_grad(), axes.model_axis(axis):
            loss = _loss(wc, batch)
            grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
        for i, (path, g) in enumerate(zip(paths, grads)):
            if g is None:
                # an embeddings batch does not reach the token embedding: zeros,
                # as jax.grad gives it; any other leaf left out is a wiring fault
                if not ("embeds" in batch and path == _TOKEN_EMBEDDING):
                    raise RuntimeError(f"the loss does not reach parameter {path!r}")
                grads[i] = torch.zeros_like(leaves[i])
        return loss.detach(), grads

    def gradients(state: TrainState, batch, seed) -> Gradients:
        if split:
            batch = PT.rank_rows(batch, mesh, PT.rank_index(mesh, transport.wire_axis),
                                 microbatches=grad_accum)
        # the working copy, as fresh autograd leaves sharing its storage
        wc = transport.prepare(compute_params(state.params, policy))
        leaves = [w.detach().requires_grad_(True) for w in tree_leaves(wc)]
        paths = tree_paths(wc)
        wc = tree_unflatten(wc, leaves)
        if grad_accum > 1:
            loss, acc = None, None
            for mb in _split_microbatches(batch, grad_accum):
                mb_loss, grads = _micro_grads(wc, leaves, paths, mb)
                if acc is None:
                    loss, acc = mb_loss.to(torch.float32), [g.to(torch.float32) for g in grads]
                else:
                    loss = loss + mb_loss
                    for a, g in zip(acc, grads):
                        a.add_(g.to(torch.float32))
                del grads
            k = torch.tensor(grad_accum, dtype=torch.float32, device=loss.device)
            loss = loss / k
            grads = [a / k for a in acc]
            del acc
        else:
            loss, grads = _micro_grads(wc, leaves, paths, batch)
        del wc, leaves
        grads = tree_unflatten(state.params, grads)
        _, wire_key = keys(int(seed), int(state.step), transport.replica)
        grads, residuals = transport.reduce(grads, state.wire_residuals, wire_key,
                                            within=within)
        loss = loss.to(torch.float32)
        if split:
            loss = wire_mean(loss.reshape(1), mesh.dp_group())[0]
        if shard_specs is None:
            grad_norm = _global_norm(grads)
        else:
            grad_norm = _sharded_norm(grads, shard_specs, mesh)
        float(grad_norm)    # the sync: a device fault of this phase surfaces here
        return Gradients(grads, loss, grad_norm,
                         None if residuals is state.wire_residuals else residuals)

    def update(state: TrainState, g: Gradients, seed) -> tuple[TrainState, dict]:
        key, _ = keys(int(seed), int(state.step), transport.replica)
        if shard_specs is not None:
            # a shard's SR bits: its leaf's stream at the shard's positions
            key = ShardKey(key, F.shard_positions(state.params, shard_specs, mesh))
        lr = lr_schedule(state.step)
        new_params, new_opt = optimizer.update(g.grads, state.opt_state, state.params,
                                               step=state.step, key=key, lr=lr)
        new_params = transport.finalize(new_params)
        residuals = state.wire_residuals
        if g.residuals is not None:
            with torch.no_grad():
                residuals = tree_unflatten(residuals, [
                    write_back(r, nr) for r, nr in zip(tree_leaves(residuals),
                                                       tree_leaves(g.residuals))])
        metrics = {"loss": g.loss, "lr": lr, "grad_norm": g.grad_norm}
        return TrainState(state.step + 1, new_params, new_opt, residuals), metrics

    def train_step(state: TrainState, batch, seed) -> tuple[TrainState, dict]:
        return update(state, gradients(state, batch, seed), seed)

    train_step.phases = (gradients, update)
    return train_step


def _global_norm(tree) -> torch.Tensor:
    with torch.no_grad():
        return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                              for g in tree_leaves(tree)))


def _sharded_norm(tree, pspecs, mesh) -> torch.Tensor:
    """The global norm of gradients held as shards (FSDP, the model axis):
    each leaf's sum of squares, summed in rank order over the ranks that
    hold its shards (those at coordinate 0 on every axis its spec does not
    name) and counted once for a replicated leaf, then over the leaves in
    order; the same bits on every rank."""
    with torch.no_grad():
        leaves = tree_leaves(tree)
        own = torch.stack([torch.sum(torch.square(g.to(torch.float32))) for g in leaves])
        parts = gather_parts(own, None)           # every rank's, in rank order
        coords = [mesh.coords(r) for r in range(len(parts))]
        total = None
        for i, spec in enumerate(tree_leaves(pspecs)):
            named = set(spec.axes)
            holders = [r for r, c in enumerate(coords)
                       if all(n == 0 for a, n in c.items() if a not in named)]
            sq = parts[holders[0]][i].clone()
            for r in holders[1:]:
                sq += parts[r][i]
            total = sq if total is None else total + sq
        return torch.sqrt(total)


def make_eval_step(cfg, policy: PrecisionPolicy, *, attn_chunk: int = 1024):
    qa = QArith(policy)

    def eval_step(params, batch):
        with torch.no_grad():
            wc = compute_params(params, policy)
            logits = R.forward_logits(qa, wc, cfg, batch, remat=False,
                                      attn_chunk=attn_chunk)
            loss = softmax_xent(logits, batch["labels"])
            acc = (logits.argmax(-1) == batch["labels"]).to(torch.float32).mean()
        return {"loss": loss, "acc": acc}

    return eval_step


def make_serve_step(cfg, policy: PrecisionPolicy, *, fused_decode: bool = False,
                    paged: bool = False, chunk: int = 1,
                    return_logits: bool = False, mesh=None, exchange=None):
    """Slot-indexed decode step:
    ``(params, cache, token, pos[, active, reset, ...]) → (next_token, cache)``.

    token (N,C) int (or (N,C,D) embeddings), pos (N,) i32 per-slot depths;
    ``mrope_positions`` ((3,N,C) i32) drive a vlm's M-RoPE (without them
    it rotates by ``pos``, standard RoPE). An encoder-decoder's cache
    (``registry.make_cache(batch=...)``) steps every lane one token, the
    lock-step decode the reference runs it in. ``reset`` ((N,) bool)
    re-initializes slots before the step (how the engine admits into a
    recycled slot), ``active`` ((N,) bool) marks the lanes that decode —
    parked lanes run at pos −1 (their KV writes change nothing), keep their
    recurrent state and report token −1. The cache is updated in place and
    returned: attention by the model's writes, recurrent state by
    :func:`repro_torch.serve.cache.keep_active`, so a captured step's
    graph reads and writes the pool's own buffers.

    ``fused_decode=True`` runs the step inside
    :func:`repro_torch.kernels.dispatch.fused_decode`, so attention
    against the pool goes through the CUDA decode kernel (the paged kernel
    for a paged pool; on CUDA a prefill chunk too, each query row a lane),
    and on CUDA the dense products through ``qmatmul`` and RMSNorm's mean
    through ``row_mean_sq``: a token row gets the same bits at every
    chunk width (ROADMAP C10).

    ``paged=True`` expects the paged cache layout
    (:func:`repro_torch.models.transformer.init_cache`) and keyword inputs
    ``block_table`` ((N, n_blocks) i32, logical block → physical page row)
    and ``page_reset`` ((R,) bool, physical pages recycled *this* step —
    their position rows go to −1, the page analogue of ``reset``), and
    optionally ``copy_dst``/``copy_src`` ((K,) i32, the copy-on-write row
    copies at a static width K, padded with ``dst`` = R rows that copy
    nothing, applied after ``page_reset`` and before the model's KV
    writes; see :func:`repro_torch.serve.cache.copy_pages`).

    ``exchange`` (a :class:`repro_torch.dist.pages.PageExchange`) serves a
    paged pool whose rows shard over data ranks (ROADMAP A12 item 3), each
    call given its step's plan as ``pages`` (a ``StepPlan``): ``cache``
    holds this rank's rows, ``page_reset`` marks its own recycled rows,
    ``block_table`` is this rank's lanes' tables remapped onto the plan's
    working buffers and ``copy_dst``/``copy_src`` are the plan's pairs of
    this rank's own rows. The step pulls the rows its lanes read into the
    working buffers (copying the pairs whose source another rank holds),
    runs the layers on them unchanged and pushes the written cells back to
    their owners (two collectives at most, host operations: the step runs
    eagerly).

    ``chunk=C > 1`` is the *chunked-prefill* variant: ``token`` is (N, C)
    and ``n_tok`` ((N,) i32) says how many of each lane's C tokens are real
    this step (1 for decode lanes, up to C for prefilling lanes; padding
    tokens run at position −1 → writes dropped, rows discarded). The
    returned token is the model output of each lane's *last real* token
    (reference ``step.py:260-387``); only that row reaches the logits
    product, which the reference computes for every row and then indexes.

    ``return_logits=True`` is the *sampling* variant: ``(next_token,
    logits, cache)`` with ``logits`` the f32 (N, V) row each lane's token
    was argmaxed from (its last real row). The token path is the greedy
    variant's op for op, so greedy lanes keep their bits next to sampling
    lanes, which :mod:`repro_torch.serve.sampling` re-decides from the
    logits.

    ``mesh`` with a ``model`` axis above 1: ``params`` and ``cache`` are
    this rank's shards (``partition.param_specs``/``cache_specs``) and the
    step runs under that axis (:mod:`repro_torch.dist.axes`): the
    vocab-parallel embedding (or a whole one), the local heads
    (``layers.head_plan``), the row-parallel ``wo`` and ``w_down`` summed
    over the model group, the logits gathered, so every
    rank of the group returns the same tokens (and logits). The slots are
    whatever the caller hands it: the engine hands each rank its own.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    qa = QArith(policy)
    axis = axes.for_mesh(mesh)

    def serve_step(params, cache, token, pos, active=None, reset=None, *,
                   mrope_positions=None, block_table=None, page_reset=None, n_tok=None,
                   copy_dst=None, copy_src=None, pages=None):
        with dispatch.fused_decode(fused_decode), axes.model_axis(axis):
            wc = compute_params(params, policy)
            if reset is not None:
                cache = SC.reset_slots(cache, reset)
            if paged and page_reset is not None:
                cache = SC.reset_pages(cache, page_reset)
            if paged and copy_dst is not None:
                cache = SC.copy_pages(cache, copy_dst, copy_src)
            pool = cache
            if pages is not None:
                # this rank's lanes read the working buffers of the rows
                # their tables name (block_table is already remapped onto them)
                cache = exchange.pull(pool, pages)
            if chunk == 1:
                cache_pos = pos if active is None else torch.where(active, pos, -1)
                last = None
            else:
                # per-token positions; tokens past a lane's n_tok (and whole
                # parked lanes) run at −1: KV writes dropped, rows discarded
                offs = torch.arange(chunk, dtype=torch.int32, device=pos.device)
                valid = offs[None, :] < n_tok[:, None]
                if active is not None:
                    valid &= active[:, None]
                cache_pos = torch.where(valid, pos[:, None] + offs[None, :], -1)
                last = torch.clamp(n_tok - 1, 0, chunk - 1)
            logits, new_cache = R.decode(qa, wc, cfg, token, cache, cache_pos,
                                         mrope_positions=mrope_positions,
                                         block_table=block_table if paged else None,
                                         out_rows=last)
            next_token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            if pages is not None:
                exchange.push(pool, new_cache, pages)
            # recurrent state back into the pool's buffers, per active lane
            new_cache = SC.keep_active(active, new_cache, pool)
            if active is not None:
                next_token = torch.where(active, next_token, -1)
            if return_logits:
                return next_token[:, None], logits[:, -1, :].to(torch.float32), new_cache
            return next_token[:, None], new_cache

    return serve_step
