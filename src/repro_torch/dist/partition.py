"""Mesh axes, placement and the batch rows of a rank (port of
``repro.dist.partition``).

The port's processes form the mesh (:mod:`repro_torch.launch.mesh`). Every
axis but ``model`` carries data parallelism: the batch's rows, and a serve
engine's slots, are split over all of them. The ``model`` axis carries
Megatron-style tensor parallelism, inferred from leaf names as in the
reference: column-parallel kernels (:data:`_COL_PARALLEL`) shard their
output features, row-parallel ones (:data:`_ROW_PARALLEL`) their input
features, the embedding its vocab rows; biases, norms and anything the
axis does not divide replicate. A :class:`Placement` with an
``fsdp_axis`` (the ``fsdp`` axis, or ``data`` as in ZeRO-3) also shards
every parameter leaf over that axis, on its largest dimension the axis
size divides that the model axis did not claim (:func:`param_specs`), and
:func:`state_shardings` co-shards every parameter-shaped optimizer buffer
with its parameter.

What the port runs on a model axis above 1 is serving and training every
family (:func:`serve_refusal`): the dense and MoE decoder-only families,
Mamba, the RG-LRU hybrid and the encoder-decoder, with head counts the
axis does not divide (the reference's padded head split,
``models/layers.py::head_plan``) and a vocabulary it does not divide (the
embedding and head whole on every rank, as the name rules leave them).
A paged pool under a data axis above 1 shards its page rows over the data
ranks (:func:`page_rows`; the rows a lane reads move through
:mod:`repro_torch.dist.pages`). Channel widths the axis does not divide
(``d_ff``, ``d_inner``, RG-LRU's width) are ROADMAP A12, FSDP beside a
model axis above 1 is A13.

:func:`batch_specs`, :func:`cache_specs` and :func:`serve_input_specs`
give the reference's specs; :func:`rank_rows` applies the batch's: a rank
takes the rows the reference gives its device — with ``microbatches=k``,
of each of the k microbatches the chunk of its index over the
data-parallel axes (microbatch split first, then the wire's chunk, then
the remaining data axes in mesh order: :func:`rank_index`,
``repro/train/step.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["MODEL_AXIS", "DATA_AXIS", "POD_AXIS", "FSDP_AXIS", "KNOWN_AXES",
           "STACKED_CACHE_ROOTS", "SERVE_ITEM", "FSDP_TP_ITEM", "P", "Placement",
           "default_placement", "dp_axes", "dp_size", "mp_size", "param_specs",
           "state_shardings", "batch_specs", "cache_specs", "serve_input_specs",
           "serve_refusal", "page_rows", "rank_index", "rank_rows"]

PyTree = Any

MODEL_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"
FSDP_AXIS = "fsdp"
# Every mesh axis name the stack understands, outermost-first.
KNOWN_AXES = (POD_AXIS, DATA_AXIS, FSDP_AXIS, MODEL_AXIS)

# where the model axis's refusals point
SERVE_ITEM = "ROADMAP A12"
FSDP_TP_ITEM = "ROADMAP A13"

# Column-parallel: shard the output-feature (last) dim of the kernel.
_COL_PARALLEL = frozenset({
    "wq", "wk", "wv",                  # attention in-projections
    "w_gate", "w_up",                  # dense MLP
    "we_gate", "we_up",                # MoE expert FFN (TP-in-expert)
    "in_proj", "in_x", "in_gate",      # mamba / rg-lru in-projections
    "w_r", "w_i",                      # rg-lru gates
    "dt_proj",                         # mamba dt head (R -> d_inner)
    "lm_head",
})
# Row-parallel: shard the input-feature (second-to-last) dim of the kernel.
_ROW_PARALLEL = frozenset({
    "wo", "w_down", "we_down", "out_proj", "out", "x_proj",
})
# Root keys whose leaves carry a leading stacked-layer dim.
_STACKED_ROOTS = frozenset({"layers", "enc_layers", "dec_layers"})
#: Decode-cache roots whose leaves carry a leading stacked-layer dim, so the
#: slot dim sits at index 1 instead of 0.
STACKED_CACHE_ROOTS = _STACKED_ROOTS | {"self", "cross"}


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
    """Which mesh axes carry parameter sharding: ``tp_axis`` the tensor
    parallelism of the name rules, ``fsdp_axis``, when set, every parameter
    leaf and its optimizer buffers besides. Axes absent from the mesh count
    as size 1."""
    fsdp_axis: Optional[str] = None
    tp_axis: Optional[str] = MODEL_AXIS

    def fsdp_size(self, mesh) -> int:
        if self.fsdp_axis is None or self.fsdp_axis not in mesh.axis_names:
            return 1
        return mesh.shape[self.fsdp_axis]

    def tp_size(self, mesh) -> int:
        if self.tp_axis is None or self.tp_axis not in mesh.axis_names:
            return 1
        return mesh.shape[self.tp_axis]


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


def mp_size(mesh) -> int:
    """The size of the model axis (1 when the mesh has none)."""
    return mesh.shape[MODEL_AXIS] if mesh is not None and MODEL_AXIS in mesh.axis_names else 1


def serve_refusal(cfg, mesh) -> Optional[str]:
    """Why the port cannot serve or train ``cfg`` on ``mesh`` (None when
    it can). On a model axis above 1 it serves and
    trains every family; head counts and a vocabulary the axis does not
    divide take the padded head split and the whole embedding. It refuses
    a channel width the axis does not divide (the MLP's or the experts'
    ``d_ff``, Mamba's ``d_inner``, RG-LRU's width, a projection's head
    columns: the name rules would leave those kernels whole, and their
    products would be summed once per rank), A12's item 2. A paged pool
    is served on any data axis (its rows shard, :func:`page_rows`)."""
    if mesh is None:
        return None
    mp = mp_size(mesh)
    if mp == 1:
        return None
    dims = [("d_ff", cfg.d_ff)] if cfg.d_ff else []
    if cfg.family == "ssm":
        dims.append(("d_inner", cfg.d_inner))
    if cfg.block_pattern:
        dims.append(("lru_width", cfg.lru_width or cfg.d_model))
    if cfg.n_heads:
        dims += [("n_heads x head_dim", cfg.n_heads * cfg.head_dim),
                 ("n_kv_heads x head_dim", cfg.n_kv_heads * cfg.head_dim)]
    for what, n in dims:
        if n % mp:
            return (f"{cfg.name}: model axis {mp} does not divide {what} {n}; channel "
                    f"shards the axis does not divide are {SERVE_ITEM} (item 2)")
    return None


def _path_names(path: str) -> list[str]:
    """The string keys along a dotted leaf path, list indices skipped."""
    return [k for k in path.split(".") if k and not k.isdigit()]


def param_specs(params: PyTree, cfg, mesh, placement: Placement | None = None) -> PyTree:
    """The spec of every parameter leaf (reference ``partition.py:143``),
    tensors or arrays (a reference tree through ``np.asarray``).
    On a model axis above 1 the name rules shard a kernel's output features
    (column-parallel), its input features (row-parallel) or the
    embedding's vocab rows, each where the axis divides the dim; biases
    and anything else replicate. With an FSDP axis every leaf is also
    sharded over it, on its largest dimension the axis size divides that
    the model axis did not claim (the first of equal ones); a leaf with no
    such dimension replicates over it. Stacked leaves count their dims
    from the end."""
    del cfg  # the rules read names and shapes only, as the reference's do
    placement = placement or Placement()
    mp = placement.tp_size(mesh)
    fs = placement.fsdp_size(mesh)

    def spec(path, leaf):
        if not hasattr(leaf, "shape"):
            return P()
        ndim = len(leaf.shape)
        parts = [None] * ndim
        names = _path_names(path)
        if mp > 1 and names and ndim:
            stacked = names[0] in _STACKED_ROOTS
            erank = ndim - (1 if stacked else 0)
            leafname = names[-1]
            base = (names[-2] if len(names) >= 2
                    and leafname in ("kernel", "bias", "w", "b") else leafname)
            dim = None
            if erank >= 2 and leafname != "bias":
                if leafname == "embedding":
                    dim = ndim - 2                 # vocab rows
                elif base in _COL_PARALLEL:
                    dim = ndim - 1
                elif base in _ROW_PARALLEL:
                    dim = ndim - 2
            if dim is not None and leaf.shape[dim] % mp == 0:
                parts[dim] = placement.tp_axis
        if fs > 1 and ndim:
            fdim = _fsdp_dim(tuple(leaf.shape), parts, fs)
            if fdim is not None:
                parts[fdim] = placement.fsdp_axis
        return P(*parts)

    return _map_paths(spec, params)


def _map_paths(fn, tree: PyTree, prefix: str = "") -> PyTree:
    """``tree_map`` whose function also gets the leaf's dotted path."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, tree[k], f"{prefix}{k}.") for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map_paths(fn, t, f"{prefix}{i}.") for i, t in enumerate(tree)]
    return fn(prefix.rstrip("."), tree)


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


def cache_specs(cache: PyTree, cfg, mesh) -> PyTree:
    """Specs of a decode cache (reference ``partition.py:246``): the slot
    (or page-row) dim over every data axis where they divide it, and on
    the model axis the kv-head dim of an attention leaf (effective rank 4)
    or the channel dim of recurrent state, where it divides. Stacked roots
    (:data:`STACKED_CACHE_ROOTS`) put the slot dim at 1. A contiguous
    attention cache is the tuple ``(k, v, k_pos)``; its positions are i32
    and stay off the model axis, as the reference's are."""
    del cfg
    dp = dp_axes(mesh)
    n = dp_size(mesh)
    mp = mp_size(mesh)

    def spec(path, leaf):
        ndim = leaf.dim()
        parts = [None] * ndim
        names = _path_names(path)
        stacked = bool(names) and names[0] in STACKED_CACHE_ROOTS
        bdim = 1 if stacked else 0
        if n > 1 and ndim > bdim and leaf.shape[bdim] % n == 0:
            parts[bdim] = dp
        if mp > 1 and leaf.is_floating_point():
            erank = ndim - (1 if stacked else 0)
            leafname = names[-1] if names else ""
            dim = None
            if leafname == "conv" or (leafname == "h" and erank == 2):
                dim = ndim - 1                     # channel-last state
            elif leafname == "h" and erank == 3:
                dim = ndim - 2                     # mamba (B, d_inner, N)
            elif erank == 4:
                dim = ndim - 2                     # the KV cache's head axis
            if dim is not None and dim != bdim and leaf.shape[dim] % mp == 0:
                parts[dim] = MODEL_AXIS
        return P(*parts)

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(node[k], f"{prefix}{k}.") for k in sorted(node)}
        if isinstance(node, tuple):           # (k, v, k_pos): the reference's tuple leaves
            return tuple(spec(f"{prefix}{i}", t) for i, t in enumerate(node))
        return spec(prefix.rstrip("."), node)

    return walk(cache, "")


def serve_input_specs(n_slots: int, mesh, *, paged: bool = False, n_rows: int | None = None,
                      chunk: int = 1) -> dict:
    """Specs of the serve step's slot-indexed inputs (reference
    ``partition.py:302``): ``token``, ``pos``, ``active``, ``reset`` (and
    ``block_table``, ``n_tok``) co-shard their slot dim with the pool's over
    every data axis, or replicate when the slots do not divide; paged,
    ``page_reset`` co-shards with the page rows and the copy-on-write lists
    replicate."""
    dp = dp_axes(mesh)
    n = dp_size(mesh)
    slot = dp if (n > 1 and n_slots % n == 0) else None
    specs = {"token": P(slot, None), "pos": P(slot), "active": P(slot), "reset": P(slot)}
    if paged:
        page = dp if (n > 1 and n_rows is not None and n_rows % n == 0) else None
        specs["block_table"] = P(slot, None)
        specs["page_reset"] = P(page)
        specs["copy_dst"] = P(None)
        specs["copy_src"] = P(None)
    if chunk > 1:
        specs["n_tok"] = P(slot)
    return specs


def page_rows(n_rows: int, mesh, index: int | None = None) -> tuple[int, int]:
    """The page rows ``[lo, hi)`` that data index ``index`` (default: this
    rank's, :func:`rank_index`) holds of a pool of ``n_rows``: the
    reference's ``P(data)`` split of the row dim (``cache_specs``), so
    index ``d`` of ``D`` holds ``[d·R/D, (d+1)·R/D)`` and the null row
    ``R − 1`` lies on the last. The pool pads ``n_rows`` to a multiple of
    ``D``; one that does not divide raises."""
    n = 1 if mesh is None else dp_size(mesh)
    if n_rows % n:
        raise ValueError(f"{n_rows} page rows do not split over {n} data ranks")
    at = 0 if n == 1 else (rank_index(mesh) if index is None else index)
    per = n_rows // n
    return at * per, (at + 1) * per


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
