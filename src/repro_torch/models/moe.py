"""Dense gated MLP and the mixture-of-experts feed-forward with
capacity-based dispatch (port of ``repro.models.moe``).

The reference's three MoE strategies, selected as there:

* ``onehot`` — GShard-style routing over all tokens at once;
* ``grouped`` — the same per group of ``cfg.moe_group_size`` tokens;
* ``gather`` — index-based dispatch, f32 combine weights.

The reference dispatches and combines the one-hot strategies with einsums
against (tokens, experts, capacity) one-hots. Every output of those
einsums selects exact values: an expert slot holds at most one token's row
(times 1), and a token's output sums at most k nonzero terms — each an
exact product of a bf16-rounded gate and a bf16 expert output — in f32,
rounded once. So this port dispatches by index (a token-id table per
expert slot) and combines by a gather and a k-term f32 sum, which gives
the einsums' bits without the O(T·E·C·D) products. :func:`_route` keeps the
reference's one-hot form for the tests.

Routing runs in f32 (the router leaf is f32 whatever the policy). Top-k
takes the lower expert index on a tie, as ``jax.lax.top_k`` does (a stable
sort). Over-capacity claims are dropped. A decode step (S = 1) routes with
the no-drop capacity T·k, so decode never drops. On the serve step's
kernel route the expert products run as one ``qmatmul`` launch per expert
and product (``layers.project``) and the router product in fixed row
blocks (``layers.f32_rows_product``), so a row's bits do not depend on how
many rows the step or an expert holds.

Under a model axis (:mod:`repro_torch.dist.axes`) the experts run tensor
parallel inside each expert, as the reference's name rules shard them:
``we_gate``/``we_up`` hold this rank's F columns, ``we_down`` its F rows,
and the router stays replicated, so routing runs alike on every rank.
Each expert's down product leaves an f32 partial; the model group's
partials of all E·C slots, (E·C, D) f32 per layer, are summed in rank
order and rounded once before the combine (one process's rounding point
of the expert outputs; after the combine it would be (T, D)). Only the
expert branch's input passes ``copy_to_model``: the router's input
gradient is already whole on every rank.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.qarith import QArith
from repro_torch.dist import axes
from repro_torch.models.layers import (_kernel_route, _normal, f32_rows_product, project,
                                       project_f32, project_row_parallel)

__all__ = ["mlp_init", "mlp_apply", "moe_init", "moe_apply"]


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32):
    s_in, s_ff = 1 / math.sqrt(d_model), 1 / math.sqrt(d_ff)
    return {
        "w_gate": _normal(gen, (d_model, d_ff), s_in, dtype),
        "w_up": _normal(gen, (d_model, d_ff), s_in, dtype),
        "w_down": _normal(gen, (d_ff, d_model), s_ff, dtype),
    }


def mlp_apply(qa: QArith, p, x, act: str = "silu"):
    """The dense MLP; under a model axis ``w_gate``/``w_up`` hold this
    rank's columns (their shared input through ``axes.copy_to_model``) and
    ``w_down`` its rows."""
    x = axes.copy_to_model(x)
    g = project(qa, x, p["w_gate"])
    u = project(qa, x, p["w_up"])
    a = qa.silu(g) if act == "silu" else qa.gelu(g)
    h = qa.mul(a, u)
    return project_row_parallel(qa, h, p["w_down"])


def moe_init(gen: torch.Generator, cfg, dtype=torch.float32):
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    s_in, s_ff = 1 / math.sqrt(D), 1 / math.sqrt(F)
    p = {
        "router": _normal(gen, (D, E), s_in, torch.float32),
        "we_gate": _normal(gen, (E, D, F), s_in, dtype),
        "we_up": _normal(gen, (E, D, F), s_in, dtype),
        "we_down": _normal(gen, (E, F, D), s_ff, dtype),
    }
    if cfg.shared_expert:
        p["shared"] = mlp_init(gen, D, F, dtype)
    return p


def _claims(x, router, top_k: int, capacity: int):
    """Top-k routing with capacity, as indices. x: (T, D).

    Returns gate values (T,k) f32, expert ids (T,k), each claim's queue slot
    within its expert, token-major (T,k), and whether it fits the capacity
    (T,k) bool."""
    E = router.shape[-1]
    if _kernel_route(x):
        logits = f32_rows_product(x, router)
    else:
        logits = torch.matmul(x.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :top_k], idx[:, :top_k]
    onehot = torch.nn.functional.one_hot(gate_idx, E)                 # (T,k,E)
    claims = onehot.reshape(-1, E)
    pos = (torch.cumsum(claims, dim=0) - claims).reshape(onehot.shape)
    slot = (pos * onehot).sum(-1)                                      # (T,k)
    return gate_vals, gate_idx, slot, slot < capacity


def _route(x, router, top_k: int, capacity: int):
    """The reference's one-hot form of the routing: (dispatch, combine),
    each (T, E, C) f32 (tests hold it against ``repro.models.moe._route``)."""
    gate_vals, gate_idx, slot, keep = _claims(x, router, top_k, capacity)
    E = router.shape[-1]
    slot_oh = torch.nn.functional.one_hot(torch.where(keep, slot, 0), capacity).float()
    exp_oh = torch.nn.functional.one_hot(gate_idx, E).float()
    disp = torch.einsum("tke,tkc->tkec", exp_oh, slot_oh * keep[..., None].float())
    return disp.sum(dim=1), torch.einsum("tkec,tk->tec", disp, gate_vals)


def _slot_table(gate_idx, slot, keep, n_tokens: int, E: int, C: int):
    """Flat slot of each claim ((T,k), E·C for a dropped one) and, per
    expert slot, the token that fills it and whether one does ((E·C,))."""
    flat = torch.where(keep, gate_idx * C + slot, E * C)
    tok = torch.arange(n_tokens, device=flat.device)[:, None].expand_as(flat)
    src = torch.zeros(E * C + 1, dtype=torch.long, device=flat.device)
    src = src.scatter(0, flat.reshape(-1), tok.reshape(-1))[:E * C]
    filled = torch.zeros(E * C + 1, dtype=torch.bool, device=flat.device)
    filled = filled.scatter(0, flat.reshape(-1), True)[:E * C]
    return flat, src, filled


def _experts_ffn(qa: QArith, p, xe, act: str):
    """(…,E,C,D) expert inputs → (…,E,C,D) outputs, 16-bit FMAC products.
    On the kernel route one ``qmatmul`` launch per expert and product.
    Under a model axis each expert's gate/up give this rank's F columns and
    its down product an f32 partial (``qmatmul_f32`` on the kernel route);
    the group's partials are summed in rank order and rounded once
    (``axes.row_parallel_sum``)."""
    tp = axes.current() is not None
    if _kernel_route(xe) or tp:
        E = xe.shape[-3]
        down = project_f32 if tp else project

        def one(e):
            x = xe[..., e, :, :]
            g = project(qa, x, p["we_gate"][e])
            u = project(qa, x, p["we_up"][e])
            a = qa.silu(g) if act == "silu" else qa.gelu(g)
            return down(qa, qa.mul(a, u), p["we_down"][e])
        ye = torch.stack([one(e) for e in range(E)], dim=-3)
        return axes.row_parallel_sum(ye, qa) if tp else ye
    g = qa.einsum("...ecd,edf->...ecf", xe, p["we_gate"])
    u = qa.einsum("...ecd,edf->...ecf", xe, p["we_up"])
    a = qa.silu(g) if act == "silu" else qa.gelu(g)
    h = qa.mul(a, u)
    return qa.einsum("...ecf,efd->...ecd", h, p["we_down"])


def _dispatch_combine(qa: QArith, p, xt, cfg, capacity: int):
    """One routing group (T, D) → (T, D): the one-hot strategies' function.
    Each expert slot takes its token's rounded row (zeros where empty); a
    token's output is its kept claims' bf16-rounded gates times their slots'
    outputs, summed in f32 over k and rounded once."""
    T, D = xt.shape
    E, C = cfg.n_experts, capacity
    gate_vals, gate_idx, slot, keep = _claims(xt, p["router"], cfg.top_k, C)
    flat, src, filled = _slot_table(gate_idx, slot, keep, T, E, C)
    # the expert branch's input (the router read xt itself)
    x = axes.copy_to_model(qa.cast(xt))
    xe = torch.where(filled[:, None], x[src], torch.zeros((), dtype=x.dtype, device=x.device))
    ye = _experts_ffn(qa, p, xe.reshape(E, C, D), cfg.act_fn).reshape(E * C, D)
    back = ye[torch.clamp(flat, max=E * C - 1)].to(torch.float32)     # (T,k,D)
    w = torch.where(keep, qa.cast(gate_vals).to(torch.float32), 0.0)
    return qa.cast(_sum_k(back * w[..., None]))


def _sum_k(t):
    """Σ over the k axis (dim 1) of (T,k,D) in index order."""
    out = t[:, 0]
    for j in range(1, t.shape[1]):
        out = out + t[:, j]
    return out


def _moe_onehot_global(qa: QArith, p, x, cfg, capacity: int):
    B, S, D = x.shape
    return _dispatch_combine(qa, p, x.reshape(B * S, D), cfg, capacity).reshape(B, S, D)


def _moe_onehot_grouped(qa: QArith, p, x, cfg):
    """Routing per group of ``cfg.moe_group_size`` tokens (the whole
    sequence when it does not divide S), capacity per group."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = min(cfg.moe_group_size or S, S)
    if S % G:
        G = S
    cap = max(1, int(cfg.capacity_factor * G * k / E))
    xg = x.reshape(-1, G, D)
    return torch.cat([_dispatch_combine(qa, p, xg[i], cfg, cap)
                      for i in range(xg.shape[0])]).reshape(B, S, D)


def _moe_gather(qa: QArith, p, x, cfg, capacity: int):
    """Index-based dispatch with f32 combine weights (the reference's
    ``gather`` strategy): empty slots hold token 0's row times 0."""
    B, S, D = x.shape
    T = B * S
    E, C = cfg.n_experts, capacity
    xt = x.reshape(T, D)
    gate_vals, gate_idx, slot, keep = _claims(xt, p["router"], cfg.top_k, C)
    flat, src, filled = _slot_table(gate_idx, slot, keep, T, E, C)
    xe = axes.copy_to_model(xt)[src] * filled[:, None].to(xt.dtype)
    ye = _experts_ffn(qa, p, xe.reshape(E, C, D), cfg.act_fn).reshape(E * C, D)
    back = ye[torch.clamp(flat, max=E * C - 1)].to(torch.float32)
    w = (gate_vals * keep.to(torch.float32))[..., None]
    return qa.cast((back * w).sum(dim=1)).reshape(B, S, D)


def moe_apply(qa: QArith, p, x, cfg, *, strategy: str | None = None):
    """x: (B,S,D) → (B,S,D), the reference's strategy choice: S = 1 (decode)
    routes all tokens with the no-drop capacity T·k; otherwise ``grouped``
    (B > 1), ``gather`` or the global one-hot with capacity
    ``capacity_factor·T·k/E``. The shared expert, if any, is added after
    (tensor parallel as the dense MLP under a model axis)."""
    B, S, _ = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    strategy = strategy or cfg.moe_strategy
    if S == 1:
        out = _moe_onehot_global(qa, p, x, cfg, capacity=T * k)
    elif strategy == "grouped" and B > 1:
        out = _moe_onehot_grouped(qa, p, x, cfg)
    elif strategy == "gather":
        out = _moe_gather(qa, p, x, cfg, max(1, int(cfg.capacity_factor * T * k / E)))
    else:
        out = _moe_onehot_global(qa, p, x, cfg, max(1, int(cfg.capacity_factor * T * k / E)))
    if cfg.shared_expert:
        out = qa.add(out, mlp_apply(qa, p["shared"], x, cfg.act_fn))
    return out
