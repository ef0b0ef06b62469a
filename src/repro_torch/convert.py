"""Parameter and train-state conversion from the reference's layout.

The reference stores a decoder-only LM as a stacked tree: every leaf under
``layers.b<i>`` carries a leading group dim, and a hybrid pattern's
remainder sits unstacked under ``rem.b<i>``. The port keeps that layout,
so conversion maps leaf for leaf and keeps each dtype (a bf16 leaf stays
bf16; the f32 ``router``, ``A_log``, ``D_skip`` and ``lambda`` of a bf16
tree stay f32). Every node is checked against the schema of the ported
families — dense attention, MoE, Mamba and RG-LRU blocks — so a leaf the
port does not have raises. It takes numpy — the caller runs
``np.asarray`` on the JAX side — so this module needs no JAX.
"""
from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.sgd import SGDState
from repro_torch.train.train_state import TrainState

__all__ = ["from_jax_dlrm_params", "from_jax_params", "from_jax_train_state"]

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
_LM = {"embed": {"embedding": None}, "final_norm": _NORM, "lm_head": _DENSE,
       "layers": _BLOCKS, "rem": _BLOCKS}


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
    raise KeyError(f"{path or 'params'}: leaf {key!r} is not in the ported decoder-only LM")


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


def from_jax_params(tree: Any, *, device=None) -> dict:
    """Nested dict of numpy arrays (the reference's ``R.init`` tree passed
    through ``np.asarray``) → the port's params on ``device`` (CUDA unless
    ``"cpu"``). Raises on a leaf the ported decoder-only LM does not have."""
    return _convert(tree, _LM, "", resolve_device(device))


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


def from_jax_train_state(state: Any, *, device=None) -> TrainState:
    """The reference's ``TrainState`` with numpy leaves (passed through
    ``jax.tree_util.tree_map(np.asarray, ...)``) → the port's
    ``TrainState`` on ``device``: params, the ``AdamWState`` (m, v, the
    0-dim c₁/c₂) or ``SGDState`` (momentum), and the Kahan buffers, each
    dtype kept. Without a gradient transport ``wire_residuals`` is None."""
    dev = resolve_device(device)
    if getattr(state, "wire_residuals", None) is not None:
        raise ValueError("wire residuals are ported with the dist slice (ROADMAP A5)")

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
    return TrainState(int(np.asarray(state.step)), tree(state.params), opt, None)
