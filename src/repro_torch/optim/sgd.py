"""SGD with momentum under every precision policy (paper Algorithms 1–3;
port of ``repro.optim.sgd``).

Variants, selected by the policy:

* ``exact`` (fp32 / mixed / bf16_master): textbook fp32 update on the
  (master) weights — the paper's 32-bit baseline and Table 3 ablation.
* ``nearest`` (bf16_standard): every op's output nearest-rounded — the
  paper's *failing* standard 16-bit-FPU algorithm.
* ``stochastic`` (bf16_sr): Algorithm 2 — the update subtraction ⊖ uses
  stochastic rounding; everything else stays nearest.
* ``kahan=True`` (bf16_kahan / bf16_sr_kahan): Algorithm 3 — a compensation
  buffer ``c`` (stored in the *param* format) accumulates the rounding
  residual of each update.

Each leaf is updated in place (see :mod:`repro_torch.optim.base`).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.policy import PrecisionPolicy
from repro_torch.optim.base import Optimizer, leafwise, param_ops, state_ops, write_back
from repro_torch.tree import tree_map

__all__ = ["SGDState", "sgd"]


class SGDState(NamedTuple):
    momentum: Any              # tree, same structure as params
    kahan_c: Any | None        # tree or None


def sgd(policy: PrecisionPolicy, *, momentum: float = 0.9,
        weight_decay: float = 0.0, nesterov: bool = False) -> Optimizer:
    sops = state_ops(policy)
    pops = param_ops(policy)
    mu = float(momentum)
    wd = float(weight_decay)

    def init(params):
        m = tree_map(sops.zeros_like, params)
        c = tree_map(pops.zeros_like, params) if policy.kahan else None
        return SGDState(m, c)

    def _leaf_update(w, g, m, c, noise, lr):
        # g, m, w read into the f32 accumulator; each named op rounds once
        gf = sops.f32(g)
        wf = pops.f32(w)
        if wd:
            gf = sops.f32(sops.q(gf + wd * wf))           # g ← g + d·w
        m_new = sops.q(mu * sops.f32(m) + gf)             # m ← μ·m + g (one FMAC)
        if nesterov:
            gf = sops.f32(sops.q(gf + mu * sops.f32(m_new)))
        else:
            gf = sops.f32(m_new)

        if policy.update_rounding == "exact":
            w_new, c_new = (wf - lr * gf).to(pops.dtype), c
        else:
            u = sops.q(lr * gf)                           # u ← η·m (rounded)
            if not policy.kahan:
                step_val = wf - pops.f32(u)               # the ⊖ subtraction
                w_new = (pops.q_sr(step_val, noise)       # Alg 2 line 5
                         if policy.update_rounding == "stochastic" else pops.q(step_val))
                c_new = c
            else:
                # Alg 3: nearest rounding on every op; the accumulate uses SR
                # when combined with it (Fig 11); wf is f32(w)
                del gf
                u_neg = pops.q(-pops.f32(u))              # u ← −η·m
                y = pops.q(pops.f32(u_neg) - pops.f32(c))  # y ← u − c
                del u, u_neg
                s_val = wf + pops.f32(y)                  # s ← w + y
                w_new = (pops.q_sr(s_val, noise)
                         if policy.update_rounding == "stochastic" else pops.q(s_val))
                del s_val
                c_new = pops.q(pops.f32(pops.q(pops.f32(w_new) - wf)) - pops.f32(y))
        # every new value is computed before the first write
        return write_back(w, w_new), write_back(m, m_new), write_back(c, c_new)

    def update(grads, state, params, *, step, key, lr):
        del step
        lr = float(np.float32(lr))
        with torch.no_grad():
            new_params, new_m, new_c = leafwise(
                lambda w, g, m, c, k: _leaf_update(w, g, m, c, k, lr),
                params, grads, state.momentum,
                state.kahan_c if policy.kahan else None, key=key)
        return new_params, SGDState(new_m, new_c if policy.kahan else None)

    return Optimizer(f"sgd[{policy.name}]", policy, init, update)
