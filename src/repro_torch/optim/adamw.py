"""AdamW under every precision policy (paper Algorithms 4–5; port of
``repro.optim.adamw``).

All optimizer state — first/second moments *and* the bias-correction
scalars c₁, c₂ — lives in the policy's state format (bf16 for 16-bit-FPU
training, the paper's Appendix B). β₁, β₂ are snapped onto the state grid
(bf16: 0.997 → 0.99609375, 0.999 → 1.0 — the trap the paper warns about);
``1 - β`` is then formed in f64 and rounded to f32 where it meets a
tensor, as in the reference. c₁, c₂ stay 0-dim tensors on the parameters'
device: CUDA divides by a CPU scalar through its reciprocal, which is not
the reference's division.

Each leaf is updated in place (see :mod:`repro_torch.optim.base`).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.formats import sqrt_rn
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.optim.base import (Optimizer, UpdateOps, leafwise, param_ops,
                                    state_ops, write_back)
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWState", "adamw", "snap"]


class AdamWState(NamedTuple):
    m: Any                  # tree of first moments
    v: Any                  # tree of second moments
    c1: torch.Tensor        # 0-dim ∏β₁ (bias correction), state format
    c2: torch.Tensor        # 0-dim ∏β₂
    kahan_c: Any | None


def snap(ops: UpdateOps, beta: float) -> float:
    """``beta`` rounded onto ``ops``' grid, as a Python float."""
    return float(ops.f32(ops.q(torch.tensor(beta, dtype=torch.float32))))


def init_state(sops: UpdateOps, buf_ops: UpdateOps, params, kahan: bool) -> AdamWState:
    """Zero moments, c₁ = c₂ = 1 on the parameters' device, and a zero
    Kahan buffer made by ``buf_ops`` when ``kahan``."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    one = torch.ones((), dtype=sops.dtype, device=device)
    c = tree_map(buf_ops.zeros_like, params) if kahan else None
    return AdamWState(tree_map(sops.zeros_like, params),
                      tree_map(sops.zeros_like, params), one, one.clone(), c)


def adamw(policy: PrecisionPolicy, *, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    sops = state_ops(policy)
    pops = param_ops(policy)
    b1q, b2q = snap(sops, b1), snap(sops, b2)

    def init(params):
        return init_state(sops, pops, params, policy.kahan)

    def _leaf(w, g, m, v, c, noise, c1_new, c2_new, lr, lr_wd):
        gf = sops.f32(g)
        wf = pops.f32(w)
        m_new = sops.q(b1q * sops.f32(m) + (1.0 - b1q) * gf)       # one FMAC
        v_new = sops.q(b2q * sops.f32(v) + (1.0 - b2q) * gf * gf)  # one FMAC
        m_hat = sops.f32(sops.q(sops.f32(m_new) / (1.0 - sops.f32(c1_new))))
        v_hat = sops.f32(sops.q(sqrt_rn(sops.f32(v_new) / (1.0 - sops.f32(c2_new)))))

        # lr·m̂ / (v̂ + eps) + (lr·wd)·w, op for op, in place on the f32
        # temporaries m̂ and v̂: the largest leaf of qwen2.5-3b has 812 M
        # elements (3.2 GB per f32 copy), so each temporary saved counts
        upd = m_hat.mul_(lr).div_(v_hat.add_(eps)).add_(lr_wd * wf)
        del gf, m_hat, v_hat
        if policy.update_rounding == "exact":
            w_new, c_new = (wf - upd).to(pops.dtype), c
        else:
            u = sops.q(upd)
            del upd
            if not policy.kahan:
                step_val = wf - sops.f32(u)                        # the ⊖ op
                w_new = (pops.q_sr(step_val, noise)                # Alg 4 l.11
                         if policy.update_rounding == "stochastic" else pops.q(step_val))
                c_new = c
            else:
                # Kahan (Alg 5 lines 12–16); wf is f32(w)
                u_neg = pops.q(-sops.f32(u))
                y = pops.q(pops.f32(u_neg) - pops.f32(c))
                del u, u_neg
                s_val = wf + pops.f32(y)
                w_new = (pops.q_sr(s_val, noise)
                         if policy.update_rounding == "stochastic" else pops.q(s_val))
                del s_val
                c_new = pops.q(pops.f32(pops.q(pops.f32(w_new) - wf)) - pops.f32(y))
        # every new value is computed before the first write
        return (write_back(w, w_new), write_back(m, m_new), write_back(v, v_new),
                write_back(c, c_new))

    def update(grads, state, params, *, step, key, lr):
        del step
        lr32 = np.float32(lr)
        lr, lr_wd = float(lr32), float(lr32 * np.float32(weight_decay))
        with torch.no_grad():
            c1_new = sops.q(sops.f32(state.c1) * b1q)                  # Alg 4 l.7
            c2_new = sops.q(sops.f32(state.c2) * b2q)
            new_p, new_m, new_v, new_c = leafwise(
                lambda w, g, m, v, c, k: _leaf(w, g, m, v, c, k, c1_new, c2_new, lr, lr_wd),
                params, grads, state.m, state.v,
                state.kahan_c if policy.kahan else None, key=key)
        return new_p, AdamWState(new_m, new_v, c1_new, c2_new,
                                 new_c if policy.kahan else None)

    return Optimizer(f"adamw[{policy.name}]", policy, init, update)
