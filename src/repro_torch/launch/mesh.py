"""Meshes over the processes of a ``torch.distributed`` group (port of
``repro.launch.mesh``).

A :class:`Mesh` names its axes' sizes over the world's ranks, rank-major
in axis order, as ``jax.make_mesh`` lays devices out: ``(data, model)``,
``(data, fsdp, model)`` with an ``fsdp`` axis, and a leading ``pod``. Any
data-parallel axes may exceed 1 together (``pods`` with ``data`` is the
hierarchical pod-over-data composition). The ``model`` axis is innermost,
so a model group is consecutive ranks; the dense families serve and train
on it (``dist/partition.py::serve_refusal``).

:func:`make_local_mesh` creates the process group of every axis above 1 —
the ranks that differ only along it: one model group per data coordinate,
the data groups across them — and the group over all data-parallel ranks,
on every rank, in the same order, once: ``new_group`` is collective, so a
group made later on some ranks only would hang.
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
    """Axis names and sizes over the processes, outermost first. A mesh
    built by :func:`make_local_mesh` holds its process groups; one built
    directly (a stand-in for the partition rules) holds none."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    groups: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coords(self, rank: int) -> dict[str, int]:
        """The coordinates of ``rank`` on every axis."""
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = rank % n
            rank //= n
        return out

    def index(self, axis: str) -> int:
        """This process's coordinate along ``axis``."""
        if axis not in self.axis_names:
            raise KeyError(axis)
        return self.coords(MH.process_index())[axis]

    def ranks_along(self, axes, rank: int | None = None) -> list[int]:
        """The ranks that differ from ``rank`` (default: this process) only
        along ``axes``, in rank order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        me = self.coords(MH.process_index() if rank is None else rank)
        return [r for r in range(self.size)
                if all(c == me[a] for a, c in self.coords(r).items() if a not in axes)]

    def group(self, axes):
        """The process group of the ranks that differ only along ``axes``
        (an axis name or a tuple of them); None when they span one rank:
        nothing crosses them."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes and self.shape[a] > 1)
        if not key:
            return None
        if key not in self.groups:
            raise ValueError(f"mesh {self.shape} has no process group over {key}: build it "
                             f"with make_local_mesh")
        return self.groups[key][tuple(self.ranks_along(key))]

    def dp_group(self):
        """The group over every data-parallel rank (the loss's and the
        gradient norm's)."""
        return self.group(PT.dp_axes(self))

    def _build_groups(self) -> None:
        """Every group :meth:`group` can return, created on every rank in
        one order: each axis above 1, then all data-parallel axes."""
        world = list(range(self.size))
        wanted = [(a,) for a, n in zip(self.axis_names, self.sizes) if n > 1]
        dp = tuple(a for a in PT.dp_axes(self) if self.shape[a] > 1)
        if dp and dp not in wanted:
            wanted.append(dp)
        for key in wanted:
            made = {}
            for r in world:
                ranks = tuple(self.ranks_along(key, r))
                if ranks not in made:
                    made[ranks] = (dist.group.WORLD if len(ranks) == self.size
                                   else dist.new_group(list(ranks)))
            self.groups[key] = made


def make_local_mesh(data: int = 1, model: int = 1, fsdp: int = 1, pods: int = 1) -> Mesh:
    """The reference's axes — ``(data, model)``, ``(data, fsdp, model)``
    with ``fsdp > 1``, a leading ``pod`` with ``pods > 1`` — over this
    process group, with its process groups. A mesh of more than one
    process must span exactly the group's processes."""
    sizes: tuple = (data, model)
    axes: tuple = (PT.DATA_AXIS, PT.MODEL_AXIS)
    if fsdp > 1:
        sizes = (data, fsdp, model)
        axes = (PT.DATA_AXIS, PT.FSDP_AXIS, PT.MODEL_AXIS)
    if pods > 1:
        sizes = (pods,) + sizes
        axes = (PT.POD_AXIS,) + axes
    mesh = Mesh(axes, sizes)
    have = MH.process_count()
    if mesh.size > 1 and mesh.size != have:
        raise ValueError(f"mesh {mesh.shape} needs {mesh.size} processes but the "
                         f"process group has {have}; size the axes to the process count")
    if mesh.size > 1:
        mesh._build_groups()
    return mesh
