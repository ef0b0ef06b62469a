"""RG-LRU recurrent block of RecurrentGemma (port of ``repro.models.rglru``).

Temporal conv + Real-Gated Linear Recurrent Unit, on the chunked
:func:`~repro_torch.models.ssm.linear_recurrence` (in f32):

    r_t = σ(W_r x_t)          recurrence gate
    i_t = σ(W_i x_t)          input gate
    a_t = exp(-c · softplus(Λ) · r_t)
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The gates are elementwise after two dense products, so on the serve step's
kernel route (``qmatmul``) a row's bits do not depend on the row count.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import sqrt_rn
from repro_torch.core.qarith import QArith
from repro_torch.models.layers import dense, dense_init
from repro_torch.models.ssm import causal_conv1d, conv_init, linear_recurrence, softplus

__all__ = ["rglru_init", "rglru_apply", "rglru_decode_step"]

_C = 8.0  # RG-LRU temperature constant from the Griffin paper


def rglru_init(gen: torch.Generator, cfg, dtype=torch.float32):
    D = cfg.d_model
    W = cfg.lru_width or cfg.d_model
    p = {
        "in_x": dense_init(gen, D, W, dtype=dtype),
        "in_gate": dense_init(gen, D, W, dtype=dtype),
        "conv": conv_init(gen, cfg.ssm_conv, W, dtype),
        "w_r": dense_init(gen, W, W, dtype=dtype),
        "w_i": dense_init(gen, W, W, dtype=dtype),
        "out": dense_init(gen, W, D, dtype=dtype),
    }
    # Λ such that a ∈ [0.9, 0.999] at r = 1 (Griffin §2.4)
    u = 0.9 + 0.099 * torch.rand((W,), generator=gen, device=gen.device)
    p["lambda"] = torch.log(torch.expm1(-torch.log(u) / _C)).to(torch.float32)
    return p


def _gates(qa: QArith, p, xs):
    r = torch.sigmoid(dense(qa, p["w_r"], xs).to(torch.float32))
    i = torch.sigmoid(dense(qa, p["w_i"], xs).to(torch.float32))
    log_a = -_C * softplus(p["lambda"]) * r
    a = torch.exp(log_a)
    # √(1 − a²) keeps the state variance O(1)
    b_scale = sqrt_rn(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, b_scale * i * xs.to(torch.float32)


def rglru_apply(qa: QArith, p, x, cfg, *, chunk: int = 256):
    """Full-sequence Griffin recurrent block. x: (B,S,D) → (B,S,D)."""
    gate = qa.gelu(dense(qa, p["in_gate"], x))
    xs = dense(qa, p["in_x"], x)
    xs, _ = causal_conv1d(qa, p["conv"], xs)
    a, b = _gates(qa, p, xs)
    hs, _ = linear_recurrence(a, b, chunk=chunk)          # (B,S,W) f32
    y = qa.cast(hs * gate.to(torch.float32))
    return dense(qa, p["out"], y)


def rglru_decode_step(qa: QArith, p, x, cfg, state):
    """One-token step. state {"conv": (B,W-1,Wd), "h": (B,Wd) f32}; returns
    (y, new state) with new tensors."""
    gate = qa.gelu(dense(qa, p["in_gate"], x))
    xs = dense(qa, p["in_x"], x)
    xs, conv_state = causal_conv1d(qa, p["conv"], xs, state["conv"])
    a, b = _gates(qa, p, xs)                               # (B,1,W)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = qa.cast(h[:, None, :] * gate.to(torch.float32))
    return dense(qa, p["out"], y), {"conv": conv_state, "h": h}
