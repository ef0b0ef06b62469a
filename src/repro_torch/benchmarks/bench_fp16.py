"""Fig 12 — Float16 (e5m10) instead of BFloat16: the dynamic-range failure
(port of ``benchmarks/bench_fp16.py``).

Two measurements: (1) a direct range probe (large-target least squares:
residuals overflow fp16's 65504 max -> divergence; bf16's e8 range copes)
— the paper's mechanism; (2) the small LM, where this shallow synthetic
task fits inside fp16's range so its extra mantissa may win slightly —
reported as measured; at production depth/scale activations leave fp16's
range, which is what (1) demonstrates."""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import row, train_tiny_lm
from repro_torch.core.formats import FORMATS, round_nearest


def _range_probe(fmt_name: str, device=None) -> float:
    """lstsq with large targets: residuals overflow fp16's 65504 max but
    sit comfortably in bf16's e8 range — the paper's core fp16 failure.
    The data and the 3000 samples' indices are drawn on the CPU, then
    gathered onto the device before the loop."""
    dev = resolve_device(device)
    fmt = FORMATS[fmt_name]
    X = (torch.randn((256, 10), generator=torch.Generator().manual_seed(0)) * 20.0).to(dev)
    w_star = (torch.rand((10,), generator=torch.Generator().manual_seed(1)) * 400.0
              + 100.0).to(dev)
    y = X @ w_star
    idx = torch.randint(0, 256, (3000,), generator=torch.Generator().manual_seed(2)).to(dev)
    xs, ys = X[idx], y[idx]
    w = torch.zeros((10,), device=dev)
    for i in range(3000):
        r = round_nearest(xs[i] @ w - ys[i], fmt)   # activation in fmt
        g = round_nearest(r * xs[i], fmt)           # grad in fmt
        w = round_nearest(w - 1e-5 * g, fmt)
    return float(torch.mean((X @ w - y) ** 2))


def run(*, device=None) -> dict:
    mse_bf = _range_probe("bf16", device)
    mse_fp = _range_probe("fp16", device)
    row("fig12_range_probe_bf16", 0.0, f"mse={mse_bf:.3e}")
    row("fig12_range_probe_fp16", 0.0, f"mse={mse_fp:.3e}")
    verdict = ("fp16_DIVERGED(overflow->NaN);bf16_trained"
               if math.isnan(mse_fp) or mse_fp > 1e3 * mse_bf else "no-gap")
    row("fig12_range_verdict", 0.0, verdict)
    res, us = {}, {}
    for pol in ("bf16_sr", "fp16_sr", "bf16_kahan", "fp16_kahan"):
        _, final, us[pol] = train_tiny_lm(pol, steps=250, init_scale=0.05, lr=1e-2,
                                          device=device)
        res[pol] = final
        row(f"fig12_lm_{pol}", us[pol], f"final_loss={final:.4f}")
    row("fig12_fp16_minus_bf16_sr", 0.0, f"{res['fp16_sr'] - res['bf16_sr']:+.4f}")
    row("fig12_fp16_minus_bf16_kahan", 0.0,
        f"{res['fp16_kahan'] - res['bf16_kahan']:+.4f}")
    return {"probe_bf16": mse_bf, "probe_fp16": mse_fp, "verdict": verdict,
            "lm": res, "lm_us": us}
