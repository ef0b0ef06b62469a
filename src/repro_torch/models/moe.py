"""Dense gated MLP (port of ``repro.models.moe``: ``mlp_init``/``mlp_apply``).

The mixture-of-experts layers arrive with the other model families.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.qarith import QArith
from repro_torch.models.layers import _normal, project

__all__ = ["mlp_init", "mlp_apply"]


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32):
    s_in, s_ff = 1 / math.sqrt(d_model), 1 / math.sqrt(d_ff)
    return {
        "w_gate": _normal(gen, (d_model, d_ff), s_in, dtype),
        "w_up": _normal(gen, (d_model, d_ff), s_in, dtype),
        "w_down": _normal(gen, (d_ff, d_model), s_ff, dtype),
    }


def mlp_apply(qa: QArith, p, x, act: str = "silu"):
    g = project(qa, x, p["w_gate"])
    u = project(qa, x, p["w_up"])
    a = qa.silu(g) if act == "silu" else qa.gelu(g)
    h = qa.mul(a, u)
    return project(qa, h, p["w_down"])
