"""Mesh axes, placement and the batch rows of a rank (port of the
data-parallel part of ``repro.dist.partition``).

The port's processes form the mesh (:mod:`repro_torch.launch.mesh`): in
this slice every axis but one has size 1, and that axis, ``data`` or
``pod``, carries plain data parallelism. Parameters are replicated across
it, so every parameter spec is ``P()``; the batch's rows are split over
it. FSDP (the ``fsdp`` axis, parameter and state sharding) is ROADMAP A9;
the ``model`` axis (tensor and expert parallelism) is A10.

:func:`batch_specs` gives the reference's specs; :func:`rank_rows` applies
them: a rank takes the rows the reference gives its replica — with
``microbatches=k``, chunk r of each of the k microbatches, in order
(microbatch split first, then the wire split, ``repro/train/step.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.tree import tree_map

__all__ = ["MODEL_AXIS", "DATA_AXIS", "POD_AXIS", "FSDP_AXIS", "KNOWN_AXES", "P",
           "Placement", "default_placement", "dp_axes", "dp_size", "param_specs",
           "batch_specs", "rank_rows"]

PyTree = Any

MODEL_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"
FSDP_AXIS = "fsdp"
# Every mesh axis name the stack understands, outermost-first.
KNOWN_AXES = (POD_AXIS, DATA_AXIS, FSDP_AXIS, MODEL_AXIS)

FSDP_ITEM = "FSDP is ported with ROADMAP A9"
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
    """Which mesh axes carry parameter sharding. In this slice none does:
    an ``fsdp_axis`` raises (A9), and ``tp_axis`` names an axis that the
    mesh keeps at size 1 (A10)."""
    fsdp_axis: Optional[str] = None
    tp_axis: Optional[str] = MODEL_AXIS

    def __post_init__(self):
        if self.fsdp_axis is not None:
            raise ValueError(f"Placement(fsdp_axis={self.fsdp_axis!r}): {FSDP_ITEM}")

    def tp_size(self, mesh) -> int:
        if self.tp_axis is None or self.tp_axis not in mesh.axis_names:
            return 1
        if mesh.shape[self.tp_axis] > 1:
            raise ValueError(f"tp_axis {self.tp_axis!r} of size "
                             f"{mesh.shape[self.tp_axis]}: {MODEL_ITEM}")
        return 1


def default_placement(mesh, *, fsdp: bool = False) -> Placement:
    """The data-parallel placement; ``fsdp=True`` raises (A9)."""
    if fsdp:
        raise ValueError(f"--fsdp: {FSDP_ITEM}")
    return Placement()


def dp_axes(mesh) -> tuple[str, ...]:
    """Every mesh axis that carries data parallelism (all but ``model``)."""
    return tuple(a for a in mesh.axis_names if a != MODEL_AXIS)


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def param_specs(params: PyTree, cfg, mesh, placement: Placement | None = None) -> PyTree:
    """Every parameter replicated (``P()``): the only layout of a
    data-parallel mesh. A model axis above 1 raises (A10)."""
    (placement or Placement()).tp_size(mesh)
    return tree_map(lambda _: P(), params)


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
