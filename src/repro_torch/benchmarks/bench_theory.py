"""Fig 2 — theory validation on least-squares regression (port of
``benchmarks/bench_theory.py``).

Loss floors: 16-bit nearest rounding on *weight updates* saturates orders
of magnitude above exact SGD; nearest rounding on *forward/backward only*
stays close to exact. derived = final MSE.

The data and the 6000 samples' indices are the reference's draws
(``make_dataset(PRNGKey(0))``, sample i ``randint(fold_in(PRNGKey(1), i))``,
in numpy through :mod:`repro_torch.core.jrandom`), so every device trains
on the reference's numbers, and the samples are gathered onto the device
before the loop, which makes no host round trip.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import row, time_fn
from repro_torch.core import jrandom
from repro_torch.core.formats import BF16, round_nearest
from repro_torch.models.lstsq import lstsq_grad_quantized, make_dataset


def _run(mode: str, steps: int = 6000, lr: float = 0.01, device=None) -> float:
    dev = resolve_device(device)
    X, y, _ = make_dataset(jrandom.PRNGKey(0), n=512, d=10, device=dev)
    return train(X, y, sample_indices(steps, X.shape[0]).to(dev), mode, lr)


def sample_indices(steps: int, n: int, seed: int = 1) -> torch.Tensor:
    """The reference's sample of step i: ``randint(fold_in(PRNGKey(seed),
    i), (), 0, n)`` (its Fig 2 takes seed 1)."""
    key = jrandom.PRNGKey(seed)
    return torch.from_numpy(np.array([jrandom.randint(jrandom.fold_in(key, i), (), 0, n)
                                      for i in range(steps)], np.int64))


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
