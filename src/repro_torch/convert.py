"""Parameter and train-state conversion from the reference's layout.

The reference stores a decoder-only LM as a stacked tree: every leaf under
``layers.b<i>`` carries a leading group dim, and a hybrid pattern's
remainder sits unstacked under ``rem.b<i>``; the encoder-decoder stacks
``enc_layers`` and ``dec_layers`` the same way. The port keeps those
layouts, so conversion maps leaf for leaf and keeps each dtype (a bf16
leaf stays bf16; the f32 ``router``, ``A_log``, ``D_skip`` and ``lambda``
of a bf16 tree stay f32). Every node is checked against the schema of the
ported families — dense attention, MoE, Mamba and RG-LRU blocks, the
encoder and decoder blocks — so a leaf the port does not have raises. The
ResNet's tree (lists of stages of block dicts, an int ``stride`` per
block) and the DLRM's have converters of their own. It takes numpy — the
caller runs ``np.asarray`` on the JAX side — so this module needs no JAX.
"""
from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.dist.fsdp import local_slice, shard_state
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.sgd import SGDState
from repro_torch.train.train_state import TrainState

__all__ = ["from_jax_dlrm_params", "from_jax_params", "from_jax_resnet_params",
           "from_jax_train_state", "to_jax_wire_residuals"]

_DENSE = {"kernel": None, "bias": None}
_NORM = {"scale": None, "bias": None}
_CONV = {"w": None, "b": None}
_MLP = {"w_gate": None, "w_up": None, "w_down": None}
# a block's mixer and ffn: one of these schemas each (tuples are alternatives)
_MIXERS = (
    {w: _DENSE for w in ("wq", "wk", "wv", "wo")},                       # attention
    {"in_proj": _DENSE, "conv": _CONV, "x_proj": _DENSE, "dt_proj": _DENSE,
     "out_proj": _DENSE, "A_log": None, "D_skip": None},                  # Mamba
    {"in_x": _DENSE, "in_gate": _DENSE, "conv": _CONV, "w_r": _DENSE, "w_i": _DENSE,
     "out": _DENSE, "lambda": None},                                      # RG-LRU
)
_FFNS = (_MLP, {"router": None, "we_gate": None, "we_up": None, "we_down": None,
                "shared": _MLP})
_BLOCK = {"ln1": _NORM, "ln2": _NORM, "mixer": _MIXERS, "ffn": _FFNS}
_BLOCKS = {r"b\d+": _BLOCK}              # b0 .. b{P-1}: a pattern group's blocks
_ATTN = _MIXERS[0]
_LM = {"embed": {"embedding": None}, "final_norm": _NORM, "lm_head": _DENSE,
       "layers": _BLOCKS, "rem": _BLOCKS,
       # the encoder-decoder's stacks
       "enc_layers": {"ln1": _NORM, "attn": _ATTN, "ln2": _NORM, "mlp": _MLP},
       "dec_layers": {"ln1": _NORM, "self_attn": _ATTN, "ln_x": _NORM,
                      "cross_attn": _ATTN, "ln2": _NORM, "mlp": _MLP},
       "enc_norm": _NORM}
_CONV_BN = {"scale": None, "bias": None}
_RESNET_BLOCK = {"conv1": None, "bn1": _CONV_BN, "conv2": None, "bn2": _CONV_BN,
                 "proj": None}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")    # owned and writable
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: move the raw bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _sub(schema: dict, key: str, path: str):
    """The schema of child ``key``: by name, or by a pattern key."""
    if key in schema:
        return schema[key]
    for pat, sub in schema.items():
        if re.fullmatch(pat, key):
            return sub
    raise KeyError(f"{path or 'params'}: leaf {key!r} is not in the ported decoder-only "
                   "LM or encoder-decoder")


def _convert(tree, schema, path: str, device):
    if schema is None:
        return _tensor(tree, device)
    if isinstance(schema, tuple):          # the alternative that has every child
        fits = [s for s in schema if set(tree) <= set(s)]
        if not fits:
            raise KeyError(f"{path}: leaves {sorted(tree)} match no ported block layout")
        schema = fits[0]
    return {k: _convert(v, _sub(schema, k, path), f"{path}.{k}".lstrip("."), device)
            for k, v in tree.items()}


def from_jax_params(tree: Any, *, device=None, specs=None, mesh=None) -> dict:
    """Nested dict of numpy arrays (the reference's ``R.init`` tree passed
    through ``np.asarray``) → the port's params on ``device`` (CUDA unless
    ``"cpu"``): any decoder-only family or the encoder-decoder. Raises on
    a leaf the ported models do not have. ``specs`` (the parameters'
    specs, ``partition.param_specs``, with ``mesh``) makes them this rank's
    shards, each cut from the numpy leaf before it reaches the device
    (:func:`repro_torch.dist.fsdp.local_slice`: a model axis's or an FSDP
    axis's dims alike)."""
    if specs is not None:
        tree = _shards(tree, specs, mesh)
    return _convert(tree, _LM, "", resolve_device(device))


def _shards(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _shards(v, specs[k], mesh) for k, v in tree.items()}
    return local_slice(np.asarray(tree), specs, mesh)


def from_jax_resnet_params(tree: Any, *, device=None) -> dict:
    """The reference's ResNet tree (``repro.models.resnet.resnet_init``
    passed through ``np.asarray``, its int ``stride`` leaves left as they
    are) → the port's on ``device`` (CUDA unless ``"cpu"``): ``stem``,
    ``stem_bn``, ``stages`` (a list per stage of block dicts, each
    ``stride`` kept a Python int) and ``head``, each dtype kept."""
    dev = resolve_device(device)
    unknown = set(tree) - {"stem", "stem_bn", "stages", "head"}
    if unknown:
        raise KeyError(f"params: leaves not in the ResNet: {sorted(unknown)}")

    def block(blk, path):
        out = {"stride": int(blk["stride"])}
        rest = {k: v for k, v in blk.items() if k != "stride"}
        out.update(_convert(rest, _RESNET_BLOCK, path, dev))
        return out

    return {"stem": _tensor(tree["stem"], dev),
            "stem_bn": _convert(tree["stem_bn"], _CONV_BN, "stem_bn", dev),
            "stages": [[block(b, f"stages.{si}.{bi}") for bi, b in enumerate(stage)]
                       for si, stage in enumerate(tree["stages"])],
            "head": _convert(tree["head"], _DENSE, "head", dev)}


def from_jax_dlrm_params(tree: Any, *, device=None) -> dict:
    """The reference's DLRM tree (``repro.models.dlrm.dlrm_init`` passed
    through ``np.asarray``) → the port's on ``device`` (CUDA unless
    ``"cpu"``): ``bottom`` and ``top`` lists of ``{kernel, bias}``,
    ``tables`` (T, V, E), each dtype kept."""
    dev = resolve_device(device)
    unknown = set(tree) - {"bottom", "tables", "top"}
    if unknown:
        raise KeyError(f"params: leaves not in the DLRM: {sorted(unknown)}")

    def mlp(layers):
        return [{k: _tensor(p[k], dev) for k in ("kernel", "bias")} for p in layers]

    return {"bottom": mlp(tree["bottom"]), "tables": _tensor(tree["tables"], dev),
            "top": mlp(tree["top"])}


def from_jax_train_state(state: Any, *, device=None, replica: int = 0, specs=None,
                         mesh=None) -> TrainState:
    """The reference's ``TrainState`` with numpy leaves (passed through
    ``jax.tree_util.tree_map(np.asarray, ...)``) → the port's
    ``TrainState`` on ``device``: params, the ``AdamWState`` (m, v, the
    0-dim c₁/c₂) or ``SGDState`` (momentum), and the Kahan buffers, each
    dtype kept. The gradient wire's residuals (one ``(n, *shape)`` stack
    per parameter leaf) become wire replica ``replica``'s ``(1, *shape)``
    rows; without a stateful transport ``wire_residuals`` is None.

    ``specs`` (a spec tree for the state,
    :func:`repro_torch.dist.fsdp.train_state_specs`, with ``mesh``) makes
    it this rank's state: every full leaf becomes this rank's part of it
    (:func:`repro_torch.dist.fsdp.shard_state`) — its FSDP shards and, from
    each residual stack, its row (the wire axis picks it; ``replica`` is
    then unused)."""
    dev = resolve_device(device)

    def rows(t):
        if t is None:
            return None
        if specs is not None:
            return _convert(_map(np.asarray, t), _LM, "", dev)
        return _convert(_map(lambda a: np.asarray(a)[replica:replica + 1], t), _LM, "", dev)

    def tree(t):
        return None if t is None else _convert(t, _LM, "", dev)

    opt = state.opt_state
    if hasattr(opt, "v"):
        opt = AdamWState(tree(opt.m), tree(opt.v), _tensor(opt.c1, dev),
                         _tensor(opt.c2, dev), tree(opt.kahan_c))
    elif hasattr(opt, "momentum"):
        opt = SGDState(tree(opt.momentum), tree(opt.kahan_c))
    else:
        raise TypeError(f"unknown optimizer state {type(opt).__name__}")
    out = TrainState(int(np.asarray(state.step)), tree(state.params), opt,
                     rows(getattr(state, "wire_residuals", None)))
    if specs is not None:
        out = shard_state(out, specs, mesh)
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def to_jax_wire_residuals(rows: list) -> dict:
    """Every wire replica's ``wire_residuals`` rows (the port's trees of
    ``(1, *shape)`` f32 tensors, in replica order) → the reference's
    ``TrainState.wire_residuals``: numpy ``(n, *shape)`` stacks."""
    def stack(*leaves):
        return np.concatenate([t.detach().cpu().numpy() for t in leaves])

    def walk(*trees):
        if isinstance(trees[0], dict):
            return {k: walk(*(t[k] for t in trees)) for k in trees[0]}
        return stack(*trees)

    return walk(*rows)
