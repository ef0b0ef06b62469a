"""Fig 2 — theory validation on least-squares regression (port of
``benchmarks/bench_theory.py``).

Loss floors: 16-bit nearest rounding on *weight updates* saturates orders
of magnitude above exact SGD; nearest rounding on *forward/backward only*
stays close to exact. derived = final MSE.

The data and the 6000 samples' indices are drawn on the CPU, so every
device trains on the same numbers, and the samples are gathered onto the
device before the loop, which makes no host round trip.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import row, time_fn
from repro_torch.core.formats import BF16, round_nearest
from repro_torch.models.lstsq import lstsq_grad_quantized, make_dataset


def _run(mode: str, steps: int = 6000, lr: float = 0.01, device=None) -> float:
    dev = resolve_device(device)
    X, y, _ = (t.to(dev) for t in make_dataset(torch.Generator().manual_seed(0),
                                               n=512, d=10))
    idx = torch.randint(0, X.shape[0], (steps,), generator=torch.Generator().manual_seed(1))
    return train(X, y, idx.to(dev), mode, lr)


def train(X: torch.Tensor, y: torch.Tensor, idx: torch.Tensor, mode: str,
          lr: float = 0.01) -> float:
    """Batch-1 SGD from w = 0 over the samples ``idx`` of (X, y), with the
    rounding of ``mode`` (``exact``, ``updates`` or ``fwdbwd``); returns
    the final MSE over all of X."""
    xs, ys = X[idx], y[idx]
    fmt = BF16 if mode == "fwdbwd" else None
    w = torch.zeros((X.shape[1],), dtype=torch.float32, device=X.device)
    for i in range(len(idx)):
        g = lstsq_grad_quantized(w, xs[i], ys[i], fmt)
        w = w - lr * g
        if mode == "updates":
            w = round_nearest(w, BF16)
    return float(torch.mean((X @ w - y) ** 2))


def run(*, device=None) -> dict:
    us = time_fn(lambda: _run("exact", steps=50, device=device), iters=1, warmup=0)
    exact = _run("exact", device=device)
    upd = _run("updates", device=device)
    fb = _run("fwdbwd", device=device)
    row("fig2_lstsq_exact", us, f"mse={exact:.4e}")
    row("fig2_lstsq_nearest_updates", us, f"mse={upd:.4e}")
    row("fig2_lstsq_nearest_fwdbwd", us, f"mse={fb:.4e}")
    row("fig2_floor_ratio_updates_vs_exact", 0.0, f"{upd / max(exact, 1e-12):.1e}")
    row("fig2_floor_ratio_fwdbwd_vs_exact", 0.0, f"{fb / max(exact, 1e-12):.1e}")
    return {"exact": exact, "updates": upd, "fwdbwd": fb, "us": us}
