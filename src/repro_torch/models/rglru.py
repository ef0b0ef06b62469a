"""RG-LRU recurrent block of RecurrentGemma (port of ``repro.models.rglru``).

Temporal conv + Real-Gated Linear Recurrent Unit, on the chunked
:func:`~repro_torch.models.ssm.linear_recurrence` (in f32):

    r_t = σ(W_r x_t)          recurrence gate
    i_t = σ(W_i x_t)          input gate
    a_t = exp(-c · softplus(Λ) · r_t)
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The gates are elementwise after two dense products, so on the serve step's
kernel route (``qmatmul``) a row's bits do not depend on the row count.

Under a model axis (:mod:`repro_torch.dist.axes`) the block runs on this
rank's share of the ``W`` channels, with the reference's name rules:
``in_x`` and ``in_gate`` are column-parallel (their shared input through
``copy_to_model``); ``conv`` and ``lambda`` are replicated and take their
local slice (``axes.local_slice``: their gradients summed over the group);
``w_r`` and ``w_i`` are column-parallel on the square ``W × W`` kernel,
so their input ``xs``, channel-sharded after the conv, is gathered whole
(``axes.gather_shards``) and ``r`` and ``i`` come out on this rank's
channels; ``out`` is row-parallel (f32 partials summed in rank order and
rounded once). The scan and the decode state (``conv`` (B, W−1, W/size),
``h`` (B, W/size)) are channel-local.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import sqrt_rn
from repro_torch.core.qarith import QArith
from repro_torch.dist import axes
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


def _inputs(qa: QArith, p, x, state=None):
    """The GELU gate and the conv's output on this rank's channels, and
    the conv's new state."""
    x = axes.copy_to_model(x)       # in_x's and in_gate's shared input
    gate = qa.gelu(dense(qa, p["in_gate"], x))
    xs, conv_state = causal_conv1d(qa, p["conv"], dense(qa, p["in_x"], x), state)
    return gate, xs, conv_state


def _gates(qa: QArith, p, xs):
    """``a`` and ``b`` on ``xs``'s channels; ``w_r`` and ``w_i`` read all
    ``W`` channels (gathered under a model axis)."""
    whole, = axes.gather_shards(xs)
    r = torch.sigmoid(dense(qa, p["w_r"], whole).to(torch.float32))
    i = torch.sigmoid(dense(qa, p["w_i"], whole).to(torch.float32))
    log_a = -_C * softplus(axes.local_slice(p["lambda"], r.shape[-1])) * r
    a = torch.exp(log_a)
    # √(1 − a²) keeps the state variance O(1)
    b_scale = sqrt_rn(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, b_scale * i * xs.to(torch.float32)


def rglru_apply(qa: QArith, p, x, cfg, *, chunk: int = 256):
    """Full-sequence Griffin recurrent block. x: (B,S,D) → (B,S,D)."""
    gate, xs, _ = _inputs(qa, p, x)
    a, b = _gates(qa, p, xs)
    hs, _ = linear_recurrence(a, b, chunk=chunk)          # (B,S,W) f32
    y = qa.cast(hs * gate.to(torch.float32))
    return dense(qa, p["out"], y, row_parallel=True)


def rglru_decode_step(qa: QArith, p, x, cfg, state):
    """One-token step. state {"conv": (B,W-1,Wd), "h": (B,Wd) f32}, Wd
    this rank's channels; returns (y, new state) with new tensors."""
    gate, xs, conv_state = _inputs(qa, p, x, state["conv"])
    a, b = _gates(qa, p, xs)                               # (B,1,Wd)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = qa.cast(h[:, None, :] * gate.to(torch.float32))
    return dense(qa, p["out"], y, row_parallel=True), {"conv": conv_state, "h": h}
