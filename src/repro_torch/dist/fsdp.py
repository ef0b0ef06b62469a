"""Fully-sharded data parallelism over the paper's 16-bit training state
(port of ``repro.dist.fsdp``).

Algorithms 4 and 5 keep pure-bf16 state — w, m, v and the Kahan c, 8
bytes per weight, as much as an fp32-master scheme spends. FSDP shards
all of it over a data axis, so bf16+Kahan costs each rank less than mixed
precision, and its gather moves the bf16 working copy, never an fp32
master.

The reference leaves the collectives to GSPMD; here each is explicit,
over the process group of the placement's FSDP axis
(:meth:`repro_torch.launch.mesh.Mesh.group`):

* a rank holds the contiguous shard of every leaf whose spec names the
  axis (:func:`local_slice`; the dim comes from
  :func:`repro_torch.dist.partition.param_specs`), and the whole of the
  others;
* :func:`all_gather_params` gathers the compute-format working copy once
  per step (cast first, then gathered: 16 bits on the wire), each leaf
  reassembled along its own dim, so dim 1 of a stacked ``(L, d, d)`` leaf
  works as dim 0 does;
* :func:`reduce_scatter_grads` reduces every gradient over the axis:
  sharded leaves with :func:`~repro_torch.optim.grad_compress.reduce_scatter_mean`
  (this rank's shard of the f32 mean), replicated ones with ``wire_mean``;
* the optimizer then updates shards only: moments, Kahan buffers and the
  wire's residual rows co-shard with their parameter.

:func:`train_state_specs` is the counterpart of ``train_state_shardings``
(a spec per leaf of a ``TrainState``); :func:`shard_state` keeps this
rank's part of every leaf of a full state (the launcher, restore and
``convert.py`` use it) and :func:`gather_full` assembles a full leaf on
process 0 (checkpoints). These helpers read any axis a spec names: the
tensor-parallel shards of the model axis go through them as FSDP's do.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.dist import multihost as MH
from repro_torch.dist import partition as PT
from repro_torch.dist.partition import P, Placement
from repro_torch.optim import grad_compress as GC
from repro_torch.tree import tree_leaves, tree_map, tree_pop_leaves, tree_unflatten

__all__ = ["unshard_spec", "gather_specs", "sharded_dims", "local_slice", "full_shape",
           "all_gather_params", "reduce_scatter_grads", "shard_positions",
           "train_state_specs", "flat_specs",
           "shard_state", "gather_full", "per_device_bytes"]

PyTree = Any


def unshard_spec(spec: P, placement: Placement) -> P:
    """``spec`` with the FSDP axis removed from every dimension entry."""
    axis = placement.fsdp_axis

    def drop(entry):
        if entry == axis:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a != axis)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return entry

    return P(*(drop(e) for e in spec))


def gather_specs(pspecs: PyTree, placement: Placement) -> PyTree:
    """Specs of the gathered working copy: the FSDP axis dropped leaf for
    leaf."""
    return tree_map(lambda s: unshard_spec(s, placement), pspecs)


def sharded_dims(spec: P) -> list[tuple[int, str]]:
    """``(dim, axis)`` of every dimension ``spec`` shards (one axis each)."""
    out = []
    for dim, entry in enumerate(spec):
        if isinstance(entry, tuple):
            raise ValueError(f"{spec}: a dimension sharded over several axes")
        if entry is not None:
            out.append((dim, entry))
    return out


def local_slice(full, spec: P, mesh):
    """This rank's part of a full leaf (a tensor or numpy array) under
    ``spec``: along every sharded dim the chunk of its coordinate on the
    dim's axis. A view; the whole leaf for ``P()``."""
    index = [slice(None)] * len(full.shape)
    for dim, axis in sharded_dims(spec):
        n = mesh.shape[axis]
        ext = full.shape[dim] // n
        if ext * n != full.shape[dim]:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split over "
                             f"{axis}={n}")
        at = mesh.index(axis) if n > 1 else 0
        index[dim] = slice(at * ext, (at + 1) * ext)
    return full[tuple(index)]


def full_shape(local_shape, spec: P, mesh) -> tuple[int, ...]:
    """The full shape of a leaf whose part on this rank has ``local_shape``."""
    shape = list(local_shape)
    for dim, axis in sharded_dims(spec):
        shape[dim] *= mesh.shape[axis]
    return tuple(shape)


def _fsdp_dim(spec: P, placement: Placement) -> int | None:
    for dim, entry in enumerate(spec):
        if entry == placement.fsdp_axis:
            return dim
    return None


def all_gather_params(params: PyTree, pspecs: PyTree, placement: Placement, mesh,
                      stats: GC.WireStats | None = None) -> PyTree:
    """The full working copy of sharded ``params``: each leaf sharded over
    the FSDP axis gathered over its group and concatenated along its dim,
    the others passed through. Pass the compute-format copy: the gather
    then moves its dtype."""
    group = mesh.group(placement.fsdp_axis) if placement.fsdp_axis else None
    if group is None:
        return params

    def gather(w, spec):
        dim = _fsdp_dim(spec, placement)
        if dim is None:
            return w
        return torch.cat(GC.gather_parts(w, group, stats, kind="gather"), dim=dim)

    return tree_map(gather, params, pspecs)


def reduce_scatter_grads(grads: PyTree, pspecs: PyTree, placement: Placement, mesh,
                         stats: GC.WireStats | None = None) -> PyTree:
    """Each gradient leaf's f32 mean over the FSDP axis: this rank's shard
    of it for a sharded leaf (``reduce_scatter_mean``), the whole for a
    replicated one (``wire_mean``). ``grads`` is emptied leaf by leaf."""
    group = mesh.group(placement.fsdp_axis) if placement.fsdp_axis else None
    if group is None:
        return grads
    specs = tree_leaves(pspecs)
    flat = tree_pop_leaves(grads)
    for i in range(len(flat)):
        g = flat[i].to(torch.float32)
        flat[i] = None
        dim = _fsdp_dim(specs[i], placement)
        flat[i] = (GC.wire_mean(g, group, stats) if dim is None
                   else GC.reduce_scatter_mean(g, dim, group, stats))
        del g
    return tree_unflatten(grads, flat)


def shard_positions(params: PyTree, pspecs: PyTree, mesh) -> list:
    """Where each leaf of ``params`` (this rank's parts) sits in its full
    leaf: ``(full_shape, dim, start)`` for a leaf sharded on one dim, None
    for a whole one — what :class:`~repro_torch.optim.base.ShardKey` needs
    to draw a shard's SR bits at its global positions."""
    out = []
    for w, spec in zip(tree_leaves(params), tree_leaves(pspecs)):
        dims = sharded_dims(spec)
        if not dims:
            out.append(None)
            continue
        if len(dims) > 1:
            raise ValueError(f"{spec}: a leaf sharded on more than one dim")
        (dim, axis), = dims
        at = mesh.index(axis) if mesh.shape[axis] > 1 else 0
        out.append((full_shape(w.shape, spec, mesh), dim, at * w.shape[dim]))
    return out


def train_state_specs(state, pspecs: PyTree | None = None, transport=None):
    """A ``TrainState`` of specs: ``step`` replicated, ``params`` the
    parameter specs (all ``P()`` when None), the optimizer state
    co-sharded with them (:func:`~repro_torch.dist.partition.state_shardings`),
    and each wire residual ``P(wire_axis, *param spec)``: the stack of the
    wire replicas' rows, its trailing dims sharded as the parameter's (the
    leading dim replicated without a wire axis)."""
    if pspecs is None:
        pspecs = tree_map(lambda w: P(*([None] * w.dim())), state.params)
    ospecs = PT.state_shardings(pspecs, state.opt_state)
    rspecs = None
    if state.wire_residuals is not None:
        axis = getattr(transport, "wire_axis", None)
        rspecs = tree_map(lambda s: P(axis, *s), pspecs)
    return type(state)(P(), pspecs, ospecs, rspecs)


def flat_specs(specs) -> list[P]:
    """The specs of a spec tree in the checkpoint's flatten order (dict
    keys sorted, NamedTuple fields in order, None contributing nothing)."""
    if specs is None:
        return []
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in flat_specs(specs[k])]
    if isinstance(specs, (tuple, list)):
        return [s for v in specs for s in flat_specs(v)]
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def shard_state(state: PyTree, specs: PyTree, mesh) -> PyTree:
    """``state`` with every tensor leaf replaced by this rank's part of it
    (an owned contiguous copy where a spec shards; the leaf itself where
    none does), residual rows included; other leaves kept."""
    def build(node, spec):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            if not sharded_dims(spec):
                return node
            return local_slice(node, spec, mesh).clone(memory_format=torch.contiguous_format)
        if isinstance(node, dict):
            return {k: build(node[k], spec[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(v, s) for v, s in zip(node, spec)))
        if isinstance(node, list):
            return [build(v, s) for v, s in zip(node, spec)]
        return node

    return build(state, specs)


def gather_full(local: torch.Tensor, spec: P, mesh) -> torch.Tensor | None:
    """The full leaf on process 0 (None elsewhere), assembled from every
    rank's part under ``spec``: collective over the world when ``spec``
    shards (each rank's part travels once to process 0, on the world
    group's device; a part that replicas share is taken from the first),
    process 0's own leaf otherwise."""
    dims = sharded_dims(spec)
    if not dims or not MH.active():
        return local if MH.is_primary() else None
    src = local.detach().to(MH.group_device()).contiguous()
    parts = ([torch.empty_like(src) for _ in range(MH.process_count())]
             if MH.is_primary() else None)
    dist.gather(src, parts, dst=0)
    if parts is None:
        return None
    out = torch.empty(full_shape(src.shape, spec, mesh), dtype=src.dtype, device=src.device)
    placed = set()
    for rank, part in enumerate(parts):
        coords = mesh.coords(rank)
        at = tuple(coords[a] for _, a in dims)
        if at in placed:
            continue
        placed.add(at)
        index = [slice(None)] * out.dim()
        for (dim, _), c in zip(dims, at):
            ext = src.shape[dim]
            index[dim] = slice(c * ext, (c + 1) * ext)
        out[tuple(index)] = part
    return out


def per_device_bytes(tree: PyTree) -> int:
    """Bytes of the tensors of ``tree`` held by this rank: the number the
    FSDP factor divides (params and optimizer state shrink by about the
    axis size against data-parallel replication)."""
    from repro_torch.train.checkpoint import flatten
    return sum(t.numel() * t.element_size() for t in flatten(tree)
               if isinstance(t, torch.Tensor))
