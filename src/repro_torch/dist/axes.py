"""The model axis as the model code sees it (the port's counterpart of
``repro.dist.axes``).

The reference's model code hints GSPMD where activations shard
(``shard_batch``/``shard_heads`` under ``activation_sharding``) and XLA
inserts the collectives. Here the engine installs a :class:`ModelAxis` —
this rank's coordinate on the model axis and that axis's process group —
with :func:`model_axis`, the model reads it with :func:`current`, and the
collectives are explicit:

* :func:`row_parallel_sum` — a row-parallel product (``wo``, ``w_down``)
  leaves each rank an f32 partial sum over its slice of the contracted
  features. The reference's all-reduce sums the f32 partials and rounds
  once; here every rank gathers the model group's partials
  (:func:`repro_torch.optim.grad_compress.gather_parts`), sums them in rank
  order in f32 and rounds the sum once to the compute dtype, so every rank
  gets the same bits;
* :func:`embed_lookup` — the vocab-parallel embedding: each rank gathers
  the rows its vocab slice holds (zero elsewhere); the rows are gathered
  and each token takes the part of the one rank that holds its id, which
  is exact;
* :func:`gather_logits` — each rank's logits over its vocab columns,
  gathered and concatenated in rank order.

Outside the context, or on a model axis of size 1, the model runs as it
does in one process. The collectives run over whatever backend the group
has; a gloo group with CUDA tensors (ranks sharing one card) moves them
through pinned host copies, whose time :class:`AxisStats` keeps apart.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Optional

import torch

from repro_torch.optim.grad_compress import WireStats, gather_parts

__all__ = ["AxisStats", "ModelAxis", "current", "model_axis", "for_mesh", "local_slice",
           "row_parallel_sum", "embed_lookup", "gather_logits"]


@dataclasses.dataclass
class AxisStats:
    """What the model axis's collectives cost this rank: their count, the
    bytes this rank handed them, the host-clock seconds inside them (host
    copies included) and, of those, the host copies' seconds."""
    calls: int = 0
    seconds: float = 0.0
    wire: WireStats = dataclasses.field(default_factory=WireStats)

    @property
    def bytes(self) -> int:
        return sum(self.wire.bytes_by_dtype.values())

    @property
    def host_copy_s(self) -> float:
        return self.wire.host_copy_s


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place on a model axis: ``size`` ranks in ``group``, this
    one at coordinate ``rank``."""
    size: int
    rank: int
    group: object
    stats: AxisStats = dataclasses.field(default_factory=AxisStats, compare=False)


_local = threading.local()


def current() -> Optional[ModelAxis]:
    """The innermost installed model axis of more than one rank, or None."""
    return getattr(_local, "axis", None)


@contextlib.contextmanager
def model_axis(axis: Optional[ModelAxis]):
    """Install ``axis`` for the enclosed model code (None: one process's
    arithmetic)."""
    prev = current()
    _local.axis = axis if axis is not None and axis.size > 1 else None
    try:
        yield _local.axis
    finally:
        _local.axis = prev


_AXES: dict = {}


def for_mesh(mesh) -> Optional[ModelAxis]:
    """The :class:`ModelAxis` of this process on ``mesh``'s ``model`` axis
    (None for ``mesh=None`` or an axis of size 1): one per process group,
    so every step function of an engine adds to the same stats."""
    from repro_torch.dist import partition as PT
    if PT.mp_size(mesh) == 1:
        return None
    group = mesh.group(PT.MODEL_AXIS)
    axis = _AXES.get(id(group))
    if axis is None or axis.group is not group:
        axis = _AXES[id(group)] = ModelAxis(PT.mp_size(mesh), mesh.index(PT.MODEL_AXIS), group)
    return axis


def local_slice(t: torch.Tensor, width: int, dim: int = -1) -> torch.Tensor:
    """This rank's ``width`` entries of a replicated ``t`` along ``dim``
    (a column-parallel product's bias); ``t`` itself when it is that wide."""
    axis = current()
    if t.shape[dim] == width:
        return t
    if axis is None or t.shape[dim] != width * axis.size:
        raise ValueError(f"a leaf of {t.shape[dim]} along dim {dim} does not split into "
                         f"{width}-wide shards over the model axis")
    return t.narrow(dim, axis.rank * width, width)


def _gather(t: torch.Tensor) -> list[torch.Tensor]:
    axis = current()
    t0 = time.perf_counter()
    parts = gather_parts(t, axis.group, axis.stats.wire)
    axis.stats.calls += 1
    axis.stats.seconds += time.perf_counter() - t0
    return parts


def row_parallel_sum(partial: torch.Tensor, qa) -> torch.Tensor:
    """The model group's f32 partial sums added in rank order in f32 and
    rounded once by ``qa``: a row-parallel product's output, the same bits
    on every rank."""
    parts = _gather(partial.to(torch.float32))
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return qa.cast(acc)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of the vocab-parallel ``table`` (this rank's
    ``(V / size, D)`` slice): each rank looks up the ids of its slice, the
    parts are gathered and every token takes its row from the rank that
    holds it. Exact: no arithmetic touches a row."""
    axis = current()
    rows = table.shape[0]
    ids = ids.long()
    mine = (ids >= axis.rank * rows) & (ids < (axis.rank + 1) * rows)
    local = table[torch.where(mine, ids - axis.rank * rows, 0)]
    local = torch.where(mine[..., None], local, torch.zeros((), dtype=local.dtype,
                                                            device=local.device))
    parts = torch.stack(_gather(local))                    # (size, *ids.shape, D)
    owner = torch.clamp(ids // rows, 0, axis.size - 1)
    return torch.gather(parts, 0, owner[None, ..., None].expand(1, *local.shape))[0]


def gather_logits(local: torch.Tensor) -> torch.Tensor:
    """Each rank's logits over its vocab columns, concatenated in rank
    order: the whole vocabulary on every rank."""
    return torch.cat(_gather(local.contiguous()), dim=-1)
