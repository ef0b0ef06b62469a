"""Mesh axes, placement and the batch rows of a rank (port of
``repro.dist.partition``, its data-parallel and FSDP parts).

The port's processes form the mesh (:mod:`repro_torch.launch.mesh`). Every
axis but ``model`` carries data parallelism: the batch's rows are split
over all of them. A :class:`Placement` with an ``fsdp_axis`` (the ``fsdp``
axis, or ``data`` as in ZeRO-3) also shards every parameter leaf over
that axis, on its largest dimension the axis size divides
(:func:`param_specs`), and :func:`state_shardings` co-shards every
parameter-shaped optimizer buffer with its parameter. Without one every
parameter spec is ``P()``. The ``model`` axis (tensor and expert
parallelism) is ROADMAP A10.

:func:`batch_specs` gives the reference's specs; :func:`rank_rows` applies
them: a rank takes the rows the reference gives its device — with
``microbatches=k``, of each of the k microbatches the chunk of its index
over the data-parallel axes (microbatch split first, then the wire's
chunk, then the remaining data axes in mesh order:
:func:`rank_index`, ``repro/train/step.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.tree import tree_map

__all__ = ["MODEL_AXIS", "DATA_AXIS", "POD_AXIS", "FSDP_AXIS", "KNOWN_AXES", "P",
           "Placement", "default_placement", "dp_axes", "dp_size", "param_specs",
           "state_shardings", "batch_specs", "rank_index", "rank_rows"]

PyTree = Any

MODEL_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"
FSDP_AXIS = "fsdp"
# Every mesh axis name the stack understands, outermost-first.
KNOWN_AXES = (POD_AXIS, DATA_AXIS, FSDP_AXIS, MODEL_AXIS)

MODEL_ITEM = "the model axis (tensor and expert parallelism) is ported with ROADMAP A10"


class P(tuple):
    """A PartitionSpec: one entry per dim, each None (replicated), an axis
    name or a tuple of names. ``P()`` replicates the whole leaf."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"

    @property
    def axes(self) -> tuple[str, ...]:
        """The mesh axes this spec shards over, in dim order."""
        out = []
        for entry in self:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    out.append(ax)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Which mesh axes carry parameter sharding: ``fsdp_axis``, when set,
    shards every parameter leaf and its optimizer buffers over that axis;
    ``tp_axis`` names an axis that the mesh keeps at size 1 (A10). Axes
    absent from the mesh count as size 1."""
    fsdp_axis: Optional[str] = None
    tp_axis: Optional[str] = MODEL_AXIS

    def fsdp_size(self, mesh) -> int:
        if self.fsdp_axis is None or self.fsdp_axis not in mesh.axis_names:
            return 1
        return mesh.shape[self.fsdp_axis]

    def tp_size(self, mesh) -> int:
        if self.tp_axis is None or self.tp_axis not in mesh.axis_names:
            return 1
        if mesh.shape[self.tp_axis] > 1:
            raise ValueError(f"tp_axis {self.tp_axis!r} of size "
                             f"{mesh.shape[self.tp_axis]}: {MODEL_ITEM}")
        return 1


def default_placement(mesh, *, fsdp: bool = False) -> Placement:
    """The data-parallel placement, or with ``fsdp=True`` FSDP over the
    mesh's ``fsdp`` axis when it has one, else over ``data`` (ZeRO-3)."""
    if not fsdp:
        return Placement()
    return Placement(fsdp_axis=FSDP_AXIS if FSDP_AXIS in mesh.axis_names else DATA_AXIS)


def dp_axes(mesh) -> tuple[str, ...]:
    """Every mesh axis that carries data parallelism (all but ``model``)."""
    return tuple(a for a in mesh.axis_names if a != MODEL_AXIS)


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def param_specs(params: PyTree, cfg, mesh, placement: Placement | None = None) -> PyTree:
    """The spec of every parameter leaf: replicated (``P()``) without an
    FSDP axis; with one, each leaf sharded over it on its largest
    dimension the axis size divides (the first of equal ones), a leaf with
    no such dimension replicated. A model axis above 1 raises (A10)."""
    del cfg  # the rules read shapes only, as the reference's FSDP rule does
    placement = placement or Placement()
    placement.tp_size(mesh)
    fs = placement.fsdp_size(mesh)

    def spec(leaf):
        if not isinstance(leaf, torch.Tensor):
            return P()
        parts = [None] * leaf.dim()
        if fs > 1 and leaf.dim():
            dim = _fsdp_dim(tuple(leaf.shape), parts, fs)
            if dim is not None:
                parts[dim] = placement.fsdp_axis
        return P(*parts)

    return tree_map(spec, params)


def _fsdp_dim(shape, parts, fs: int) -> int | None:
    """Largest dimension divisible by ``fs`` that no axis already claims."""
    best = None
    for dim, extent in enumerate(shape):
        if parts[dim] is not None or extent == 0 or extent % fs:
            continue
        if best is None or extent > shape[best]:
            best = dim
    return best


def _structure(node):
    """A tree's structure: containers and their keys, leaves as ``*``."""
    if node is None:
        return None
    if isinstance(node, dict):
        return ("dict",) + tuple((k, _structure(node[k])) for k in sorted(node))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return (type(node).__name__,) + tuple(_structure(v) for v in node)
    if isinstance(node, list):
        return ("list",) + tuple(_structure(v) for v in node)
    return "*"


def state_shardings(pspecs: PyTree, opt_state: PyTree, mesh=None) -> PyTree:
    """Specs of the optimizer state, aligned with the parameter specs: a
    subtree shaped like the parameter tree (moments, momentum, Kahan
    buffers) takes ``pspecs`` leaf for leaf, every other leaf (the
    bias-correction scalars) replicates, a None subtree stays None."""
    del mesh
    pdef = _structure(pspecs)

    def walk(node):
        if node is None:
            return None
        if _structure(node) == pdef:
            return pspecs
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, list):
            return [walk(v) for v in node]
        return P()

    return walk(opt_state)


def _batch_dim(name: str) -> int:
    """Batch dim of a batch leaf: 1 for ``mrope_positions`` ((3,B,S)),
    else 0."""
    return 1 if name == "mrope_positions" else 0


def batch_specs(batch: dict, mesh) -> dict:
    """Shard every input's batch dim on the data axes (replicate the rest).
    ``mrope_positions`` carries its batch in dim 1; a batch the data axes
    do not divide replicates."""
    dp = dp_axes(mesh)
    n = dp_size(mesh)

    def spec(name, leaf):
        parts = [None] * leaf.dim()
        bdim = _batch_dim(name)
        if n > 1 and leaf.dim() > bdim and leaf.shape[bdim] % n == 0:
            parts[bdim] = dp
        return P(*parts)

    return {name: spec(name, x) for name, x in batch.items()}


def rank_index(mesh, first: str | None = None, rank: int | None = None) -> int:
    """The index of ``rank`` (default: this process) over the data-parallel
    axes: ``first`` (the wire's axis) outermost, then the other data axes
    in mesh order — the chunk of a microbatch whose rows it computes."""
    axes = dp_axes(mesh)
    if first is not None and first in axes:
        axes = (first,) + tuple(a for a in axes if a != first)
    coords = mesh.coords(rank) if rank is not None else {a: mesh.index(a) for a in axes}
    index = 0
    for a in axes:
        index = index * mesh.shape[a] + coords[a]
    return index


def rank_rows(batch: dict, mesh, index: int, *, microbatches: int = 1) -> dict:
    """The rows of ``batch`` that replica ``index`` of the data axes
    computes, on the dim :func:`batch_specs` shards: of each of
    ``microbatches`` equal microbatches, the ``index``-th of
    ``dp_size(mesh)`` equal chunks, concatenated in order. A batch that
    would replicate (the axes, times the microbatches, do not divide it)
    raises: every rank would compute the same rows."""
    n = dp_size(mesh)
    if n == 1:
        return batch
    k = microbatches
    out = {}
    for (name, x), spec in zip(batch.items(), batch_specs(batch, mesh).values()):
        bdim = _batch_dim(name)
        rows = x.shape[bdim]
        if spec[bdim] is None or rows % (n * k):
            raise ValueError(f"global batch {rows} of {name!r} not divisible by "
                             f"{k} microbatch(es) x {n} data-parallel replicas")
        step = rows // (n * k)
        idx = torch.cat([torch.arange(m * n * step + index * step,
                                      m * n * step + (index + 1) * step)
                         for m in range(k)]).to(x.device)
        out[name] = x.index_select(bdim, idx)
    return out
