"""Step builders (port of ``repro.train.step``: ``compute_params`` and the
slot-indexed serve step; the train step arrives with the training slice).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.formats import round_nearest
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.qarith import QArith
from repro_torch.kernels import dispatch
from repro_torch.models import registry as R
from repro_torch.serve import cache as SC

__all__ = ["compute_params", "make_serve_step"]

PyTree = Any


def _tree_map(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def compute_params(params: PyTree, policy: PrecisionPolicy) -> PyTree:
    """Working copy of the weights in the compute format.

    * pure-16-bit policies: storage *is* the compute copy (no-op)
    * master-copy policies (fp32 / mixed / ablation): one RNE cast per tensor
    * simulated sub-16-bit: already grid-snapped f32, used as-is
    """
    if not policy.master_weights or policy.compute_format.name == "fp32":
        return params
    if policy.compute_format.name == "bf16":
        return _tree_map(lambda w: w.to(torch.bfloat16), params)
    return _tree_map(lambda w: round_nearest(w, policy.compute_format), params)


def make_serve_step(cfg, policy: PrecisionPolicy, *, fused_decode: bool = False,
                    paged: bool = False, chunk: int = 1,
                    return_logits: bool = False):
    """Slot-indexed greedy decode step:
    ``(params, cache, token, pos[, active, reset]) → (next_token, cache)``.

    token (N,1) int, pos (N,) i32 per-slot depths; ``reset`` ((N,) bool)
    re-initializes slots before the step (how the engine admits into a
    recycled slot), ``active`` ((N,) bool) marks the lanes that decode —
    parked lanes run at pos −1 (their KV write changes nothing) and report
    token −1. The cache is updated in place and returned.

    ``fused_decode=True`` runs the step inside
    :func:`repro_torch.kernels.dispatch.fused_decode`, so attention against
    the pool goes through the CUDA decode kernel. The paged pool, chunked
    prefill and the logits-returning sampling variant are later slices.
    """
    if paged:
        raise ValueError("the paged KV pool is ported with the paged-serving slice")
    if chunk != 1:
        raise ValueError("chunked prefill (chunk > 1) is ported with the "
                         "paged-serving slice")
    if return_logits:
        raise ValueError("the logits-returning step is ported with the sampling slice")
    qa = QArith(policy)

    def serve_step(params, cache, token, pos, active=None, reset=None):
        with dispatch.fused_decode(fused_decode):
            wc = compute_params(params, policy)
            if reset is not None:
                cache = SC.reset_slots(cache, reset)
            if active is not None:
                pos = torch.where(active, pos, -1)
            logits, new_cache = R.decode(qa, wc, cfg, token, cache, pos)
            next_token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            if active is not None:
                new_cache = SC.keep_active(active, new_cache, cache)
                next_token = torch.where(active, next_token, -1)
            return next_token[:, None], new_cache

    return serve_step
