"""Meshes over the processes of a ``torch.distributed`` group (port of
``repro.launch.mesh``).

A :class:`Mesh` names its axes' sizes over the world's ranks, rank-major
in axis order, as ``jax.make_mesh`` lays devices out. In this slice at
most one axis exceeds 1, ``data`` or ``pod``, and its process group is the
world. ``model > 1`` is ROADMAP A10; ``fsdp > 1``, and ``data`` and
``pod`` both above 1 (the hierarchical composition, whose inner transport
reduce-scatters), are A9.
"""
from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist

from repro_torch.dist import multihost as MH
from repro_torch.dist import partition as PT

__all__ = ["Mesh", "make_local_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes over the processes, outermost first."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def index(self, axis: str) -> int:
        """This process's coordinate along ``axis``."""
        pos = MH.process_index()
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            if name == axis:
                return pos % n
            pos //= n
        raise KeyError(axis)

    def group(self, axis: str):
        """The process group of the ranks that differ only along ``axis``
        (None for an axis of size 1: nothing crosses it)."""
        if self.shape.get(axis, 1) == 1:
            return None
        return dist.group.WORLD


def make_local_mesh(data: int = 1, model: int = 1, fsdp: int = 1, pods: int = 1) -> Mesh:
    """The reference's axes — ``(data, model)``, ``(data, fsdp, model)``
    with ``fsdp > 1``, a leading ``pod`` with ``pods > 1`` — over this
    process group. A mesh of more than one process must span exactly the
    group's processes."""
    if model > 1:
        raise ValueError(f"model={model}: {PT.MODEL_ITEM}")
    if fsdp > 1:
        raise ValueError(f"fsdp={fsdp}: {PT.FSDP_ITEM}")
    if data > 1 and pods > 1:
        raise ValueError(f"data={data} with pods={pods} is the hierarchical pod-over-data "
                         f"wire, whose inner transport is ported with ROADMAP A9")
    sizes: tuple = (data, model)
    axes: tuple = (PT.DATA_AXIS, PT.MODEL_AXIS)
    if pods > 1:
        sizes = (pods,) + sizes
        axes = (PT.POD_AXIS,) + axes
    mesh = Mesh(axes, sizes)
    have = MH.process_count()
    if mesh.size > 1 and mesh.size != have:
        raise ValueError(f"mesh {mesh.shape} needs {mesh.size} processes but the "
                         f"process group has {have}; size the axes to the process count")
    return mesh
