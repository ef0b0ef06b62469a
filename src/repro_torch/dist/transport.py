"""Pluggable gradient transport: how gradients cross the wire (port of
``repro.dist.transport``, the data-parallel strategies).

A :class:`GradientTransport` owns the gradient path of a train step: the
step calls ``prepare`` (the working copy's placement before the forward:
FSDP's gather), ``reduce`` (the cross-replica mean) and ``finalize`` (the
new parameters' placement), and names no collective itself.

**A replica is a rank.** The reference vmaps each microbatch's n chunks
onto its wire axis and reduces gradients stacked ``(n, *shape)``. Here a
replica is a rank of the process group over the wire axis: each rank
computes its own chunk's gradients, and ``reduce`` takes them unstacked
and returns the mean every rank shares. Each rank holds only its own
``(1, *shape)`` row of the error-feedback residuals (the reference's leaf
is the ``(n, *shape)`` stack of the rows); checkpoints gather the rows
(:mod:`repro_torch.train.checkpoint`).

Strategies, selected per mesh axis:

* :class:`Fp32Psum` — with no wire axis, a pass-through: the reference
  leaves the data-parallel mean to GSPMD inside the backward, and the
  port's step takes that mean itself (f32, over the data axes that are not
  the wire's: :meth:`GradientTransport.hint_axes`). With a wire axis (the
  ``pod`` axis of a multi-pod mesh) the per-rank gradients are upcast to
  f32 and mean-reduced over it: 4 bytes per element on the wire.
* :class:`CompressedWire` — each rank stochastically rounds ``g +
  residual`` onto the wire format and keeps the rounding error for the
  next step (:mod:`repro_torch.optim.grad_compress`): 2 bytes per element
  at bf16. With one replica (no mesh, or the axis absent) the same
  arithmetic runs locally, with no collective.
* :class:`ReduceScatter` — the FSDP path (:mod:`repro_torch.dist.fsdp`):
  ``prepare`` gathers the working copy over the FSDP axis, ``reduce``
  reduce-scatters the gradients onto the parameters' shards, ``finalize``
  keeps the new parameters sharded. As the inner of a pod wire
  (:class:`CompressedWire`, or ``_Fp32Wire`` for the f32 one) it is the
  hierarchical composition: the reduce-scatter within each pod, the wire
  across pods on the shards. Each rank's residual row is then ``(1,
  *shard_shape)``; the reference's ``P(wire_axis, *pspec)`` leaf is the
  stack of those rows.

**Each data-parallel axis is reduced exactly once, in the reference's
order.** Its GSPMD backward sums over the axes that are not the wire's
inside each wire chunk, before the wire sees the chunk's gradient. Here a
transport's ``reduce`` runs its inner's reduce-scatter (over the FSDP
axis) first, then ``within`` — the step's f32 mean over
:meth:`GradientTransport.hint_axes`, the data axes that neither the
wire nor the reduce-scatter reduce — and the wire last.

Every reduction is :func:`~repro_torch.optim.grad_compress.wire_mean` or
its reduce-scatter: gather (or all-to-all), rank-order f32 sum, one
rounding to the carrier, so every rank holding a value gets the same bits
on every backend and at every n. The transport counts what its collectives
moved in ``stats`` (:class:`~repro_torch.optim.grad_compress.WireStats`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.core.formats import BF16, FORMATS, FP32, FloatFormat
from repro_torch.dist import fsdp as F
from repro_torch.dist import partition as PT
from repro_torch.dist.partition import Placement
from repro_torch.optim import grad_compress as GC
from repro_torch.tree import tree_leaves, tree_pop_leaves, tree_unflatten

__all__ = ["GradientTransport", "Fp32Psum", "ReduceScatter", "CompressedWire",
           "WirePolicy", "make_transport", "leaf_names"]

PyTree = Any


def _wire_size(mesh, axis: Optional[str]) -> int:
    if mesh is None or axis is None or axis not in mesh.axis_names:
        return 1
    return mesh.shape[axis]


def leaf_names(tree: PyTree, prefix: str = "") -> list[str]:
    """Every leaf's path as ``jax.tree_util.keystr`` renders it
    (``['layers']['b0']['mixer']['wq']['kernel']``, ``[0]`` for a list
    index), in leaf order: what the keep policy's patterns match."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_names(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, list):
        return [p for i, t in enumerate(tree) for p in leaf_names(t, f"{prefix}[{i}]")]
    return [prefix]


@dataclasses.dataclass(frozen=True)
class WirePolicy:
    """Per-leaf wire-format selection: which gradients skip compression.

    Leaves with fewer than ``keep_below`` elements, or whose path contains
    any of ``keep_patterns`` (matched case-insensitively), ride fp32; the
    rest take the configured low format."""

    keep_below: int = 2048
    keep_patterns: tuple[str, ...] = ("embed", "norm", "bias", "scale")

    def format_for(self, name: str, size: int, base_fmt: FloatFormat) -> FloatFormat:
        """Wire format for one leaf: ``base_fmt`` or the fp32 keep."""
        lname = name.lower()
        if size < self.keep_below or any(p in lname for p in self.keep_patterns):
            return FP32
        return base_fmt

    def describe(self) -> str:
        pats = ",".join(self.keep_patterns) or "-"
        return f"keep<{self.keep_below}|{pats}"

    @classmethod
    def parse(cls, spec: str) -> "WirePolicy":
        """Build from a ``--wire-keep-fp32`` spec: comma-separated tokens, a
        numeric token sets ``keep_below``, every other token is a name
        pattern; ``"default"`` (or ``""``) is the stock policy, ``"none"``
        keeps nothing."""
        spec = (spec or "").strip()
        if spec in ("", "default"):
            return cls()
        if spec == "none":
            return cls(keep_below=0, keep_patterns=())
        keep_below = 0
        patterns: list[str] = []
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if tok.isdigit():
                keep_below = int(tok)
            else:
                patterns.append(tok)
        return cls(keep_below=keep_below, keep_patterns=tuple(patterns))


class GradientTransport:
    """Strategy interface for the gradient path of one train step::

        wc = transport.prepare(compute_params(state.params, policy))
        loss, grads = ...forward/backward of this rank's rows...
        grads, new_residuals = transport.reduce(grads, state.wire_residuals, key,
                                                within=mean_over_hint_axes)
        new_params, new_opt = optimizer.update(grads, ...)
        new_params = transport.finalize(new_params)

    ``wire_replicas`` (n) and ``wire_axis`` describe the explicit wire;
    ``replica`` is this rank's index on it; ``scatter_axis`` is the axis
    an FSDP inner reduce-scatters (None without one). Stateless transports
    keep ``init_residuals`` at None and pass residuals through."""

    name = "base"
    wire_axis: Optional[str] = None
    wire_replicas: int = 1
    scatter_axis: Optional[str] = None
    mesh = None

    def __init__(self):
        self.stats = GC.WireStats()

    @property
    def replica(self) -> int:
        """This rank's index on the wire axis (0 without one)."""
        return self.mesh.index(self.wire_axis) if self.wire_replicas > 1 else 0

    def init_residuals(self, params: PyTree) -> PyTree | None:
        """Zero error-feedback state for ``TrainState.wire_residuals``."""
        return None

    def prepare(self, wc: PyTree) -> PyTree:
        return wc

    def reduce(self, grads: PyTree, residuals: PyTree | None, key, *,
               within: Callable | None = None) -> tuple[PyTree, PyTree | None]:
        """Cross-replica reduction; returns (mean grads, new residuals).
        ``within(grads)`` is the mean over :meth:`hint_axes`, applied after
        the inner reduce-scatter and before the wire. A reducing transport
        empties ``grads`` (its leaves become None), releasing each leaf once
        reduced; the residuals it is given are not written (the caller
        stores the new ones)."""
        return (within(grads) if within else grads), residuals

    def finalize(self, params: PyTree) -> PyTree:
        return params

    def hint_axes(self, mesh) -> tuple[tuple[str, ...], int]:
        """Every data-parallel axis except the wire's and the one the inner
        reduce-scatters, and their size product: the axes whose mean the
        reference leaves to GSPMD and the port's step takes explicitly."""
        axes = tuple(a for a in PT.dp_axes(mesh)
                     if a not in (self.wire_axis, self.scatter_axis))
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        return axes, size


class Fp32Psum(GradientTransport):
    """Pass-through without a wire axis; with one of n > 1 ranks, the
    f32 mean of every leaf over it (4 bytes per element on the wire)."""

    name = "fp32_psum"

    def __init__(self, *, axis: Optional[str] = None, mesh=None, pspecs: PyTree | None = None):
        super().__init__()
        self.wire_axis = axis if _wire_size(mesh, axis) > 1 else None
        self.wire_replicas = _wire_size(mesh, axis)
        self.mesh = mesh
        self.pspecs = pspecs

    def reduce(self, grads, residuals, key, *, within=None):
        if within is not None:
            grads = within(grads)
        if self.wire_replicas == 1:
            return grads, residuals
        group = self.mesh.group(self.wire_axis)
        leaves = tree_pop_leaves(grads)
        out = []
        for i in range(len(leaves)):
            out.append(GC.wire_mean(leaves[i].to(torch.float32), group, self.stats))
            leaves[i] = None
        return tree_unflatten(grads, out), residuals


class ReduceScatter(GradientTransport):
    """The FSDP path (:mod:`repro_torch.dist.fsdp`): ``prepare`` gathers the
    working copy over the placement's FSDP axis, ``reduce`` reduce-scatters
    the gradients onto the parameters' shards (then ``within``),
    ``finalize`` keeps the parameters sharded. No wire axis of its own."""

    name = "reduce_scatter"

    def __init__(self, pspecs: PyTree, placement: Placement, mesh=None):
        super().__init__()
        self.pspecs = pspecs
        self.placement = placement
        self.mesh = mesh
        self.scatter_axis = placement.fsdp_axis

    def prepare(self, wc):
        return F.all_gather_params(wc, self.pspecs, self.placement, self.mesh, self.stats)

    def reduce(self, grads, residuals, key, *, within=None):
        grads = F.reduce_scatter_grads(grads, self.pspecs, self.placement, self.mesh,
                                       self.stats)
        return (within(grads) if within else grads), residuals


class CompressedWire(GradientTransport):
    """SR-compressed wire with per-leaf Kahan error-feedback residuals.

    Each rank quantizes ``g + residual`` onto ``fmt``'s grid with SR, the
    carrier payloads cross the wire, and the residual keeps the
    quantization error for the next step. ``fmt`` is any wire format: bf16
    (the default), bf14/bf12/bf10, fp16, or the fp8 formats e5m2/e4m3
    (clamped at ``max_finite``). ``policy`` (a :class:`WirePolicy`)
    keeps matching leaves at fp32. Residual leaves are f32 ``(1,
    *param_shape)``: this rank's row of the reference's ``(n, *shape)``
    buffer (fp32-kept leaves keep theirs too, always zero, so a format or
    policy change never changes checkpoint shapes)."""

    name = "compressed_wire"

    def __init__(self, *, axis: str = PT.POD_AXIS, mesh=None,
                 inner: GradientTransport | None = None, pspecs: PyTree | None = None,
                 fmt: FloatFormat = BF16, policy: WirePolicy | None = None):
        if fmt.name == "fp32":
            raise ValueError("CompressedWire with an fp32 format is the "
                             "Fp32Psum transport; use wire='fp32'")
        super().__init__()
        self.mesh = mesh
        self.inner = inner or Fp32Psum()
        self.inner.stats = self.stats        # one account of the step's collectives
        self.scatter_axis = self.inner.scatter_axis
        self.pspecs = pspecs
        self.fmt = fmt
        self.policy = policy
        self.wire_replicas = _wire_size(mesh, axis)
        self.wire_axis = axis if self.wire_replicas > 1 else None

    @property
    def wire_format(self) -> str:
        """Stable identity of the wire numerics (checkpoint drift key)."""
        if self.policy is None:
            return self.fmt.name
        return f"{self.fmt.name}+{self.policy.describe()}"

    def _numel(self, tree: PyTree) -> list[int]:
        """Each leaf's element count as a parameter's: a rank's shard
        counts the whole parameter (the keep policy's threshold is about
        it). Under parameter specs the leaves are this rank's parts."""
        leaves = tree_leaves(tree)
        if self.pspecs is None or self.mesh is None:
            return [leaf.numel() for leaf in leaves]
        return [math.prod(F.full_shape(leaf.shape, spec, self.mesh))
                for leaf, spec in zip(leaves, tree_leaves(self.pspecs))]

    def leaf_formats(self, tree: PyTree) -> list[FloatFormat]:
        """Wire format per leaf of ``tree`` (params or grads, whole or this
        rank's shards: the format follows the parameter's name and size)."""
        leaves = tree_leaves(tree)
        if self.policy is None:
            return [self.fmt] * len(leaves)
        return [self.policy.format_for(name, n, self.fmt)
                for name, n in zip(leaf_names(tree), self._numel(tree))]

    def payload_bytes(self, params: PyTree) -> int:
        """Accounted wire bytes for one reduce: Σ n_elem · bits(fmt)/8 over
        the leaves given (a rank's shards under FSDP), the format's width
        and not the carrier's, rounded up once."""
        bits = sum(leaf.numel() * f.bits
                   for leaf, f in zip(tree_leaves(params), self.leaf_formats(params)))
        return -(-bits // 8)

    def init_residuals(self, params):
        return tree_unflatten(params, [torch.zeros((1, *w.shape), dtype=torch.float32,
                                                   device=w.device)
                                       for w in tree_leaves(params)])

    def prepare(self, wc):
        return self.inner.prepare(wc)

    def finalize(self, params):
        return self.inner.finalize(params)

    def reduce(self, grads, residuals, key, *, within=None):
        """``key`` is this replica's randomness: ``key.leaf(i)`` rounds
        leaf i (a :class:`~repro_torch.optim.grad_compress.WireKey`, or a
        ``GivenKey`` of given bits; under FSDP each rank draws its shard's
        shape from it, as the reference's ``shard_map`` body does)."""
        if residuals is None:
            raise ValueError(
                "CompressedWire needs error-feedback residuals: build the "
                "state with make_train_state(params, opt, transport=...) so "
                "TrainState.wire_residuals is initialized")
        grads, _ = self.inner.reduce(grads, None, key, within=within)
        fmts = self.leaf_formats(grads)
        leaves = tree_pop_leaves(grads)
        rows = [r[0] for r in tree_leaves(residuals)]
        if self.wire_replicas == 1:
            out, new_res = [], []
            for i, (r, fmt) in enumerate(zip(rows, fmts)):
                q, nr = GC.compress_leaf(leaves[i], r, key.leaf(i), fmt)
                leaves[i] = None
                out.append(q.to(torch.float32))
                new_res.append(nr)
                del q
        else:
            out, new_res = GC.compressed_psum(leaves, rows, key,
                                              self.mesh.group(self.wire_axis), fmts,
                                              self.stats)
        return (tree_unflatten(grads, out),
                tree_unflatten(grads, [r[None] for r in new_res]))


def make_transport(*, mesh=None, placement: Placement | None = None,
                   pspecs: PyTree | None = None, wire: str = "fp32",
                   wire_axis: Optional[str] = None,
                   wire_policy: WirePolicy | None = None) -> GradientTransport:
    """The transport for a (mesh, placement) pair.

    ``wire`` selects the cross-pod strategy (``--grad-wire``):

    * ``"fp32"`` — :class:`Fp32Psum`, with an explicit f32 wire axis only
      when the mesh has a ``pod`` axis (or ``wire_axis`` names one);
      otherwise the pass-through;
    * ``"compressed"`` — :class:`CompressedWire` at bf16 on ``wire_axis``
      (default: ``pod`` when the mesh has one, else ``data``);
    * a format name (``bf16``, ``bf14``, ``bf12``, ``bf10``, ``fp16``,
      ``e5m2``, ``e4m3``) — :class:`CompressedWire` at that format.

    ``wire_policy`` adds the per-leaf fp32 keep on a compressed wire and is
    ignored for ``"fp32"``. An FSDP placement (with ``pspecs``) makes the
    inner a :class:`ReduceScatter` (standalone for ``fp32`` without a pod
    axis); otherwise the inner is the plain mean.

    On a ``model`` axis above 1 the leaves are this rank's tensor-parallel
    shards (``pspecs``): the wire and the mean ride the data and pod axes
    only, each rank's residual rows take its shards' shapes, and a wire on
    the model axis is refused. FSDP with a model axis above 1 is
    ROADMAP A13.
    """
    fsdp_on = (placement is not None and placement.fsdp_axis is not None
                and pspecs is not None)
    if fsdp_on and PT.mp_size(mesh) > 1 and placement.fsdp_size(mesh) > 1:
        raise ValueError(f"FSDP over {placement.fsdp_axis!r} with a model axis above 1 "
                         f"(mesh {mesh.shape}) is {PT.FSDP_TP_ITEM}")
    inner = (ReduceScatter(pspecs, placement, mesh) if fsdp_on
             else Fp32Psum(mesh=mesh, pspecs=pspecs))
    if wire == "fp32":
        axis = wire_axis
        if axis is None and mesh is not None and PT.POD_AXIS in mesh.axis_names:
            axis = PT.POD_AXIS
        if axis is None or _wire_size(mesh, axis) <= 1:
            return inner
        _check_wire_axis_free(axis, mesh, placement)
        if fsdp_on:
            # the f32 pod wire over the FSDP inner: the reduce-scatter within
            # each pod, then the pod mean of the shards
            return _Fp32Wire(axis=axis, mesh=mesh, inner=inner, pspecs=pspecs)
        return Fp32Psum(axis=axis, mesh=mesh, pspecs=pspecs)
    if wire == "compressed" or wire in FORMATS:
        fmt = BF16 if wire == "compressed" else FORMATS[wire]
        axis = wire_axis
        if axis is None:
            axis = (PT.POD_AXIS if mesh is not None and PT.POD_AXIS in mesh.axis_names
                    else PT.DATA_AXIS)
        _check_wire_axis_free(axis, mesh, placement)
        return CompressedWire(axis=axis, mesh=mesh, inner=inner, pspecs=pspecs, fmt=fmt,
                              policy=wire_policy)
    raise ValueError(f"unknown gradient wire {wire!r}; "
                     f"expected 'fp32', 'compressed', or a format name "
                     f"({', '.join(n for n in FORMATS if n != 'fp32')})")


def _check_wire_axis_free(axis, mesh, placement: Placement | None) -> None:
    """A wire axis must not double as a parameter-sharding axis (the
    model axis among them: its ranks hold different shards)."""
    if _wire_size(mesh, axis) <= 1:
        return
    if axis == PT.MODEL_AXIS or (placement is not None
                                 and axis in (placement.fsdp_axis, placement.tp_axis)):
        raise ValueError(
            f"gradient wire axis {axis!r} is already claimed by the "
            f"placement ({placement}); give the wire its own data axis — "
            f"a pod axis (--pods) or a dedicated fsdp axis "
            f"(--fsdp-parallel) so the wire can ride 'data'")


class _Fp32Wire(Fp32Psum):
    """The f32 pod wire over an FSDP inner: the inner's reduce-scatter (and
    ``within``) first, then the pod mean of the shards."""

    def __init__(self, *, axis: str, mesh, inner: GradientTransport,
                 pspecs: PyTree | None = None):
        super().__init__(axis=axis, mesh=mesh, pspecs=pspecs)
        self.inner = inner
        self.inner.stats = self.stats
        self.scatter_axis = inner.scatter_axis

    def prepare(self, wc):
        return self.inner.prepare(wc)

    def reduce(self, grads, residuals, key, *, within=None):
        grads, _ = self.inner.reduce(grads, None, key, within=within)
        return super().reduce(grads, residuals, key)

    def finalize(self, params):
        return self.inner.finalize(params)
