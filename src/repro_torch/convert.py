"""Parameter conversion from the reference's layout.

The reference stores the dense LM as a stacked tree: every leaf under
``layers.b0`` carries a leading layer dim L. The port keeps that layout,
so conversion maps leaf for leaf and keeps each dtype (a bf16 leaf stays
bf16). It takes numpy — the caller runs ``np.asarray`` on the JAX side —
so this module needs no JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["from_jax_params"]

_DENSE_LM = {
    "embed": {"embedding": None},
    "final_norm": {"scale": None},
    "layers": {"b0": {
        "ln1": {"scale": None},
        "ln2": {"scale": None},
        "mixer": {w: {"kernel": None, "bias": None} for w in ("wq", "wk", "wv", "wo")},
        "ffn": {"w_gate": None, "w_up": None, "w_down": None},
    }},
}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")    # owned and writable
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: move the raw bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree, schema, path: str, device):
    if schema is None:
        return _tensor(tree, device)
    unknown = set(tree) - set(schema)
    if unknown:
        raise KeyError(f"{path or 'params'}: leaves not in the ported dense LM: "
                       f"{sorted(unknown)}")
    return {k: _convert(v, schema[k], f"{path}.{k}".lstrip("."), device)
            for k, v in tree.items()}


def from_jax_params(tree: Any, *, device=None) -> dict:
    """Nested dict of numpy arrays (the reference's ``R.init`` tree passed
    through ``np.asarray``) → the port's params on ``device`` (CUDA unless
    ``"cpu"``). Raises on a leaf the ported dense LM does not have."""
    return _convert(tree, _DENSE_LM, "", resolve_device(device))
