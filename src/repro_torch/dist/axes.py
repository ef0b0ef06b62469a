"""The model axis as the model code sees it (the port's counterpart of
``repro.dist.axes``).

The reference's model code hints GSPMD where activations shard
(``shard_batch``/``shard_heads`` under ``activation_sharding``) and XLA
inserts the collectives, forward and backward. Here the engine or the
train step installs a :class:`ModelAxis` — this rank's coordinate on the
model axis and that axis's process group — with :func:`model_axis`, the
model reads it with :func:`current`, and the collectives are explicit
``autograd.Function`` s, Megatron's pair among them:

* :func:`copy_to_model` (Megatron's *f*) — the identity on the input
  every column-parallel product of a group shares (``wq/wk/wv``,
  ``w_gate/w_up``, the logits); its backward sums the model group's f32
  partial input-gradients in rank order and rounds the sum once;
* :func:`row_parallel_sum` (*g*) — a row-parallel product (``wo``,
  ``w_down``) leaves each rank an f32 partial sum over its slice of the
  contracted features. The reference's all-reduce sums the f32 partials
  and rounds once; here every rank gathers the model group's partials
  (:func:`repro_torch.optim.grad_compress.gather_parts`), sums them in rank
  order in f32 and rounds the sum once to the compute dtype, so every rank
  gets the same bits. Its backward hands the replicated cotangent to this
  rank's partial;
* :func:`vocab_whole` — whether this rank holds the whole vocabulary
  (no axis, or one that does not divide it: ``param_specs`` then leaves
  the embedding and the head whole), the one rule the embedding, the
  logits and the loss read;
* :func:`embed_lookup` — the vocab-parallel embedding: each rank gathers
  the rows its vocab slice holds (zero elsewhere); the rows are gathered
  and each token takes the part of the one rank that holds its id, which
  is exact. Its backward sends this rank's rows of the replicated
  cotangent to its slice;
* :func:`vocab_parallel_xent` — the training loss on this rank's vocab
  columns of the logits: three (B, S) f32 gathers (max, sum of ``exp``,
  the label's logit), the gradient ``softmax − onehot`` on the local
  columns;
* :func:`gather_logits` — each rank's logits over its vocab columns,
  gathered and concatenated in rank order (serving);
* :func:`own_halves` — the exchange of a column-parallel output whose
  halves are two tensors (Mamba's ``in_proj``, ``(D, 2·Di)`` split
  contiguously): the rank holding a half's columns sends each rank that
  rank's channels of it (one all-to-all, no arithmetic), so every rank
  gets both halves of its own channels; its backward is the inverse
  exchange;
* :func:`gather_shards` — column-parallel outputs whole on every rank
  (the shards concatenated in rank order; exact), where a shard holds
  part of a unit later work needs whole: a head the axis splits (k and v
  of fewer kv heads than ranks, q of query heads the axis does not
  divide, the attention output before ``wo``), RG-LRU's channels before
  its square gate kernels. Its backward sums the ranks' cotangents in
  f32 in rank order, rounds once and keeps this rank's columns.

Each Function captures the :class:`ModelAxis` at forward time, and its
backward never reads :func:`current`: the installed axis is thread-local,
and on CUDA autograd runs the backward (a remat recompute included) on a
thread of its own.

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

from repro_torch.optim.grad_compress import WireStats, exchange_parts, gather_parts

__all__ = ["AxisStats", "ModelAxis", "current", "model_axis", "for_mesh", "local_slice",
           "copy_to_model", "row_parallel_sum", "vocab_whole", "embed_lookup", "vocab_parallel_xent",
           "gather_logits", "own_halves", "gather_shards"]


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
    (a column-parallel product's bias); ``t`` itself when it is that wide.
    The slice's gradient, zero off this rank's entries, is summed over the
    model group (:func:`copy_to_model`), so every rank gets the whole
    replicated leaf's."""
    axis = current()
    if t.shape[dim] == width:
        return t
    if axis is None or t.shape[dim] != width * axis.size:
        raise ValueError(f"a leaf of {t.shape[dim]} along dim {dim} does not split into "
                         f"{width}-wide shards over the model axis")
    return copy_to_model(t).narrow(dim, axis.rank * width, width)


def _gather(t: torch.Tensor, axis: ModelAxis) -> list[torch.Tensor]:
    t0 = time.perf_counter()
    parts = gather_parts(t, axis.group, axis.stats.wire)
    axis.stats.calls += 1
    axis.stats.seconds += time.perf_counter() - t0
    return parts


def _rank_order_sum(t: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The model group's ``t`` summed in rank order in f32: the same bits
    on every rank. The parts cross in ``t``'s dtype (a bf16 partial's
    upcast is exact, so gathering it before the upcast halves the bytes)."""
    parts = _gather(t, axis)
    acc = parts[0].to(torch.float32, copy=True)
    for p in parts[1:]:
        acc += p.to(torch.float32)
    return acc


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _rank_order_sum(g, ctx.axis).to(g.dtype), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's *f*: ``x`` itself, the input the column-parallel
    products of a group share; its gradient is the model group's f32
    partial input-gradients summed in rank order and rounded once to
    ``x``'s dtype. ``x`` itself outside a model axis."""
    axis = current()
    return x if axis is None else _CopyToModel.apply(x, axis)


class _RowParallelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, qa, axis):
        return qa.cast(_rank_order_sum(partial, axis))

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.float32), None, None


def row_parallel_sum(partial: torch.Tensor, qa) -> torch.Tensor:
    """The model group's f32 partial sums added in rank order in f32 and
    rounded once by ``qa``: a row-parallel product's output, the same bits
    on every rank. Its gradient is the replicated cotangent, in f32, on
    this rank's partial."""
    return _RowParallelSum.apply(partial, qa, current())


class _SelectOwner(torch.autograd.Function):
    """Every rank's rows gathered and each token's taken from the rank
    that owns its id; the backward keeps this rank's tokens of the
    replicated cotangent."""

    @staticmethod
    def forward(ctx, local, owner, axis):
        ctx.save_for_backward(owner)
        ctx.rank = axis.rank
        parts = torch.stack(_gather(local, axis))           # (size, *ids.shape, D)
        return torch.gather(parts, 0, owner[None, ..., None].expand(1, *local.shape))[0]

    @staticmethod
    def backward(ctx, g):
        owner, = ctx.saved_tensors
        return torch.where((owner == ctx.rank)[..., None], g, torch.zeros((), dtype=g.dtype,
                                                                          device=g.device)), \
            None, None


def vocab_whole(vocab: int) -> bool:
    """Whether this rank holds the whole vocabulary of ``vocab`` ids: no
    model axis is installed, or its size does not divide ``vocab``, so
    that ``partition.param_specs`` leaves the embedding and the head
    whole. The lookup, the logits and the loss are then one process's on
    every rank, and so is each rank's gradient of the embedding and of
    the head."""
    axis = current()
    return axis is None or vocab % axis.size != 0


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of the vocab-parallel ``table`` (this rank's
    ``(V / size, D)`` slice): each rank looks up the ids of its slice, the
    parts are gathered and every token takes its row from the rank that
    holds it. Exact: no arithmetic touches a row. The gradient reaches
    this rank's slice at the rows of its own tokens."""
    axis = current()
    rows = table.shape[0]
    ids = ids.long()
    mine = (ids >= axis.rank * rows) & (ids < (axis.rank + 1) * rows)
    local = table[torch.where(mine, ids - axis.rank * rows, 0)]
    local = torch.where(mine[..., None], local, torch.zeros((), dtype=local.dtype,
                                                            device=local.device))
    owner = torch.clamp(ids // rows, 0, axis.size - 1)
    return _SelectOwner.apply(local, owner, axis)


class _VocabParallelXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, labels, ignore, axis):
        V = local.shape[-1]
        lo = axis.rank * V
        mine = (labels >= lo) & (labels < lo + V)
        at = torch.where(mine, labels - lo, 0).long()
        top = local.amax(dim=-1)
        # the global max: exact in any order
        top = torch.stack(_gather(top.contiguous(), axis)).amax(dim=0)
        sumexp = torch.exp(local - top[..., None]).sum(dim=-1)
        gold = torch.where(mine, torch.gather(local, -1, at[..., None])[..., 0],
                           torch.zeros((), dtype=local.dtype, device=local.device))
        logz = top + torch.log(_rank_order_sum(sumexp, axis))
        # one rank holds each label: the others add zeros
        gold = _rank_order_sum(gold, axis)
        mask = (labels != ignore).to(torch.float32)
        count = torch.clamp(mask.sum(), min=1.0)
        ctx.save_for_backward(local, logz, at, mine, mask, count)
        return ((logz - gold) * mask).sum() / count

    @staticmethod
    def backward(ctx, g):
        local, logz, at, mine, mask, count = ctx.saved_tensors
        grad = torch.exp(local - logz[..., None])
        grad.scatter_add_(-1, at[..., None], -mine.to(grad.dtype)[..., None])
        return grad * (mask * (g / count))[..., None], None, None, None


def vocab_parallel_xent(local: torch.Tensor, labels: torch.Tensor, *,
                        ignore: int = -1) -> torch.Tensor:
    """Mean next-token cross entropy of the logits whose vocab columns
    this rank holds (``local`` (B, S, V / size) f32, ranks in vocab order),
    the reference's ``softmax_xent`` over the gathered logits: each rank's
    f32 max, sum of ``exp`` and the label's logit over its columns,
    combined over the group in rank order (three (B, S) f32 gathers);
    positions labelled ``ignore`` do not count. The gradient ``softmax −
    onehot`` stays on the local columns."""
    axis = current()
    if axis is None:
        raise ValueError("vocab_parallel_xent needs an installed model axis")
    return _VocabParallelXent.apply(local.to(torch.float32), labels, ignore, axis)


def gather_logits(local: torch.Tensor) -> torch.Tensor:
    """Each rank's logits over its vocab columns, concatenated in rank
    order: the whole vocabulary on every rank."""
    return torch.cat(_gather(local.contiguous(), current()), dim=-1)


def _halves_route(size: int, rank: int) -> tuple[list[int], list[int]]:
    """A two-half column-parallel output as 2·size chunks of equal width:
    rank r's columns are chunks 2r and 2r + 1, and chunk g is half g //
    size of rank g % size's channels. Returns where this rank's two chunks
    go and where its two halves come from."""
    return ([(2 * rank + j) % size for j in (0, 1)],
            [(h * size + rank) // 2 for h in (0, 1)])


def _exchange(pieces: torch.Tensor, to, frm, axis: ModelAxis) -> torch.Tensor:
    t0 = time.perf_counter()
    out = exchange_parts(pieces, to, frm, axis.group, axis.stats.wire)
    axis.stats.calls += 1
    axis.stats.seconds += time.perf_counter() - t0
    return out


class _OwnHalves(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, axis):
        ctx.axis = axis
        to, frm = _halves_route(axis.size, axis.rank)
        pieces = torch.stack(local.chunk(2, dim=-1))            # (2, ..., w)
        return torch.cat(list(_exchange(pieces, to, frm, axis)), dim=-1)

    @staticmethod
    def backward(ctx, g):
        to, frm = _halves_route(ctx.axis.size, ctx.axis.rank)
        pieces = torch.stack(g.chunk(2, dim=-1))
        return torch.cat(list(_exchange(pieces, frm, to, ctx.axis)), dim=-1), None


def own_halves(local: torch.Tensor) -> torch.Tensor:
    """This rank's channels of both halves of a column-parallel output
    whose full width is two tensors ``[a | b]`` (Mamba's ``in_proj``:
    ``x`` and ``z``): ``local`` holds this rank's contiguous share of the
    ``2·W`` columns; the result is ``[a_own | b_own]``, each ``W / size``
    wide, the same layout one process's ``chunk(2)`` splits. Exact (an
    all-to-all of whole columns); the gradient returns each column's
    cotangent to the rank whose product made it. ``local`` itself outside
    a model axis."""
    axis = current()
    return local if axis is None else _OwnHalves.apply(local, axis)


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, *locals_):
        ctx.axis = axis
        ctx.width = locals_[0].shape[-1]
        parts = _gather(torch.stack(locals_), axis)          # size x (n, ..., w)
        return tuple(torch.cat([p[i] for p in parts], dim=-1) for i in range(len(locals_)))

    @staticmethod
    def backward(ctx, *grads):
        axis, w = ctx.axis, ctx.width
        total = _rank_order_sum(torch.stack(grads), axis).to(grads[0].dtype)
        return (None, *(t.narrow(-1, axis.rank * w, w).contiguous() for t in total))


def gather_shards(*locals_: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each of ``locals_`` (column-parallel outputs of one shape: this
    rank's share of their last dim) whole on every rank, the shards
    concatenated in rank order: exact, no arithmetic, one collective for
    all of them. The gradient of a result is the model group's
    cotangents summed in f32 in rank order, rounded once to its dtype,
    at this rank's columns (each rank's cotangent covers the columns its
    later work read: the sum is the whole one). ``locals_`` themselves
    outside a model axis."""
    axis = current()
    if axis is None:
        return locals_
    return _GatherShards.apply(axis, *locals_)
