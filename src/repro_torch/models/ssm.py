"""Mamba-1 selective SSM and the chunked linear-recurrence engine (port of
``repro.models.ssm``).

The recurrence ``h_t = a_t ⊙ h_{t-1} + b_t`` runs as the reference runs
it: a loop over chunks carrying the boundary state, folded into each
chunk's first step, and inside a chunk the recursive odd/even pair scan of
``jax.lax.associative_scan`` (:func:`associative_scan`), so every combine
rounds in the same place. Under a native 16-bit policy Mamba carries the
recurrence in the compute dtype (each combine rounds to bf16, as the
reference's), otherwise in f32. The reference's scan is XLA code, not a
Pallas kernel, so this is plain PyTorch.

On the serve step's kernel route (``layers._kernel_route``) the decode
step's ``C·h`` contraction over the state axis is a pairwise tree of
elementwise adds and its f32 ``dt_proj`` product runs in fixed row blocks
(``layers.f32_rows_product``), so a row's bits do not depend on the
number of rows.

Under a model axis (:mod:`repro_torch.dist.axes`) the block runs on this
rank's share of the ``d_inner`` channels, with the reference's name rules
and its contiguous split of ``in_proj``: ``in_proj`` is column-parallel
and :func:`~repro_torch.dist.axes.own_halves` exchanges its output so
each rank holds ``x`` and ``z`` of its own channels; ``conv``, ``A_log``,
``D_skip`` and ``dt_proj``'s bias take their local slice of the
replicated leaf (their gradients summed over the group); ``x_proj`` is
row-parallel (f32 partials, summed in rank order and rounded once) and its
replicated output ``dbc`` passes ``copy_to_model``, since Δ, B and C feed
channel-local work; ``dt_proj`` is column-parallel and ``out_proj``
row-parallel. The scan and the decode state are channel-local.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.qarith import QArith
from repro_torch.dist import axes
from repro_torch.models.layers import (_kernel_route, _normal, dense, dense_init,
                                      f32_rows_product)

__all__ = ["linear_recurrence", "associative_scan", "mamba_init", "mamba_apply",
           "mamba_decode_step", "causal_conv1d", "conv_init", "softplus", "tree_sum"]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def tree_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis as a pairwise tree of elementwise adds (halves,
    a zero column where odd): an order fixed by the axis length alone."""
    while t.shape[-1] > 1:
        if t.shape[-1] % 2:
            t = torch.cat([t, torch.zeros_like(t[..., :1])], dim=-1)
        h = t.shape[-1] // 2
        t = t[..., :h] + t[..., h:]
    return t[..., 0]


def _combine(x, y):
    (ax, bx), (ay, by) = x, y
    return ax * ay, ay * bx + by


def _interleave(a, b):
    """a0, b0, a1, b1, … along dim 1 (a has as many or one more)."""
    n = b.shape[1]
    out = torch.stack([a[:, :n], b], dim=2).reshape(a.shape[0], 2 * n, *a.shape[2:])
    return out if a.shape[1] == n else torch.cat([out, a[:, n:]], dim=1)


def associative_scan(a, b):
    """Inclusive scan of ``(a, b)`` along dim 1 under ``_combine``, in
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs, scan
    those, then fill in the even elements."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def linear_recurrence(a, b, h0=None, *, chunk: int = 256, project=None):
    """h_t = a_t * h_{t-1} + b_t along dim 1. a, b: (B, S, ...).

    Returns (y (B,S,…), h_last (B,…)); y = h unless ``project(h_chunk, j)``
    maps chunk j's states (B,chunk,…) to its outputs inside the loop (the
    Mamba C·h contraction). A ragged tail is padded with a = 1, b = 0."""
    B, S = a.shape[0], a.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        pad = chunk - S % chunk
        a = torch.cat([a, a.new_ones((B, pad, *a.shape[2:]))], dim=1)
        b = torch.cat([b, b.new_zeros((B, pad, *b.shape[2:]))], dim=1)
    n = a.shape[1] // chunk
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    outs = []
    for j in range(n):
        a_i = a[:, j * chunk:(j + 1) * chunk]
        b_i = b[:, j * chunk:(j + 1) * chunk]
        # fold the carry into the chunk's first step
        b_i = torch.cat([b_i[:, :1] + a_i[:, :1] * h[:, None], b_i[:, 1:]], dim=1)
        _, bb = associative_scan(a_i, b_i)
        outs.append(bb if project is None else project(bb, j))
        h = bb[:, -1]
    return torch.cat(outs, dim=1)[:, :S], h


# ---------------------------------------------------------------------------
# Causal depthwise conv (Mamba / RG-LRU temporal conv)
# ---------------------------------------------------------------------------

def conv_init(gen: torch.Generator, width: int, channels: int, dtype=torch.float32):
    return {"w": _normal(gen, (width, channels), 1 / math.sqrt(width), dtype),
            "b": torch.zeros((channels,), dtype=dtype, device=gen.device)}


def causal_conv1d(qa: QArith, p, x, state=None):
    """Depthwise causal conv. x: (B,S,C); state: (B,W-1,C) history or None.
    Returns (y, new_state), new_state the trailing W−1 inputs. Under a
    model axis ``x`` holds this rank's channels and the replicated weight
    and bias add their local slice."""
    C = x.shape[-1]
    p = {"w": axes.local_slice(p["w"], C), "b": axes.local_slice(p["b"], C)}
    W = p["w"].shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xx = torch.cat([state.to(x.dtype), x], dim=1)
    xf = xx.to(torch.float32)
    S = x.shape[1]
    y = sum(xf[:, i:i + S] * p["w"][i].to(torch.float32) for i in range(W))
    y = y + p["b"].to(torch.float32)
    new_state = xx[:, -(W - 1):] if W > 1 else state
    return qa.cast(y), new_state


# ---------------------------------------------------------------------------
# Mamba-1 block
# ---------------------------------------------------------------------------

def mamba_init(gen: torch.Generator, cfg, dtype=torch.float32):
    D, Di, N, R = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_eff
    dev = gen.device
    p = {
        "in_proj": dense_init(gen, D, 2 * Di, dtype=dtype),
        "conv": conv_init(gen, cfg.ssm_conv, Di, dtype),
        "x_proj": dense_init(gen, Di, R + 2 * N, dtype=dtype),
        "dt_proj": dense_init(gen, R, Di, bias=True, dtype=dtype),
        "out_proj": dense_init(gen, Di, D, dtype=dtype),
        # S4D-real init: A = -(1..N) per channel, stored as log
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev)
                           [None, :].repeat(Di, 1)),
        "D_skip": torch.ones((Di,), dtype=torch.float32, device=dev),
    }
    # dt bias → softplus⁻¹ of dt in [1e-3, 1e-1]
    u = torch.rand((Di,), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    p["dt_proj"]["bias"] = (dt + torch.log1p(-torch.exp(-dt))).to(dtype)
    return p


def _ssm_coeffs(qa: QArith, p, xs, cfg):
    """Δ, B, C of post-conv activations xs (B,S,Di): a_t (B,S,Di,N),
    b_t (B,S,Di,N) and C (B,S,N), f32."""
    N, R = cfg.ssm_state, cfg.dt_rank_eff
    Di = xs.shape[-1]
    dbc = dense(qa, p["x_proj"], xs, row_parallel=True).to(torch.float32)
    # replicated Δ, B, C feeding this rank's channels: their cotangents sum
    dbc = axes.copy_to_model(dbc)
    dt_r, Bc, Cc = dbc[..., :R], dbc[..., R:R + N], dbc[..., R + N:]
    if _kernel_route(dt_r):
        dt_lin = f32_rows_product(dt_r, p["dt_proj"]["kernel"])
    else:
        dt_lin = torch.einsum("bsr,rd->bsd", dt_r, p["dt_proj"]["kernel"].to(torch.float32))
    dt = softplus(dt_lin + axes.local_slice(p["dt_proj"]["bias"], Di).to(torch.float32))
    A = -torch.exp(axes.local_slice(p["A_log"], Di, dim=0))
    da = torch.exp(dt[..., None] * A)
    db = dt[..., None] * Bc[..., None, :] * xs.to(torch.float32)[..., None]
    return da, db, Cc


def mamba_apply(qa: QArith, p, x, cfg, *, chunk: int = 256):
    """Full-sequence Mamba block. x: (B,S,D) → (B,S,D). C·h is contracted
    per chunk inside the recurrence loop."""
    xs, z = _in_proj(qa, p, x)
    xs, _ = causal_conv1d(qa, p["conv"], xs)
    xs = qa.silu(xs)
    da, db, Cc = _ssm_coeffs(qa, p, xs, cfg)
    S = x.shape[1]
    chunk = min(chunk, S)
    n = -(-S // chunk)
    Cpad = torch.cat([Cc, Cc.new_zeros((Cc.shape[0], n * chunk - S, Cc.shape[2]))], dim=1)

    def project(h_chunk, j):                       # (B,c,Di,N) → (B,c,Di)
        Cj = Cpad[:, j * chunk:(j + 1) * chunk]
        return torch.einsum("bcdn,bcn->bcd", h_chunk.to(torch.float32), Cj)

    # the recurrence in the compute dtype under native policies (each
    # combine rounds as a 16-bit FPU op), else f32
    rec_dtype = qa.dtype if qa.policy.native else torch.float32
    y, _ = linear_recurrence(da.to(rec_dtype), db.to(rec_dtype), chunk=chunk,
                             project=project)
    y = y + _d_skip(p, xs) * xs.to(torch.float32)
    y = qa.cast(y * F.silu(z.to(torch.float32)))
    return dense(qa, p["out_proj"], y, row_parallel=True)


def _in_proj(qa: QArith, p, x):
    """``x`` and ``z`` of this rank's channels: the column-parallel
    ``in_proj`` (its input through ``copy_to_model``), exchanged so each
    rank holds both halves of its own channels (one process: the product
    split in two)."""
    xz = axes.own_halves(dense(qa, p["in_proj"], axes.copy_to_model(x)))
    return xz.chunk(2, dim=-1)


def _d_skip(p, xs):
    return axes.local_slice(p["D_skip"], xs.shape[-1]).to(torch.float32)


def mamba_decode_step(qa: QArith, p, x, cfg, state):
    """One-token step. x: (B,1,D); state {"conv": (B,W-1,Di), "h": (B,Di,N)
    f32}, of this rank's channels under a model axis. Returns (y, new
    state) with new tensors: the caller selects them into the cache per
    lane (``serve.cache.keep_active``)."""
    xs, z = _in_proj(qa, p, x)
    xs, conv_state = causal_conv1d(qa, p["conv"], xs, state["conv"])
    xs = qa.silu(xs)
    da, db, Cc = _ssm_coeffs(qa, p, xs, cfg)              # (B,1,Di,N)
    h = da[:, 0] * state["h"] + db[:, 0]                  # (B,Di,N) f32
    if _kernel_route(h):
        y = tree_sum(h * Cc[:, 0][:, None, :])
    else:
        y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])
    y = y[:, None, :] + _d_skip(p, xs) * xs.to(torch.float32)
    y = qa.cast(y * F.silu(z.to(torch.float32)))
    return dense(qa, p["out_proj"], y, row_parallel=True), {"conv": conv_state, "h": h}
