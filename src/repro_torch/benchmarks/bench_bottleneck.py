"""Fig 1 / Table 3 — the accuracy bottleneck ablation (port of
``benchmarks/bench_bottleneck.py``).

standard 16-bit-FPU vs fp32 vs the ablation (bf16 everywhere EXCEPT fp32
weights + exact updates). The ablation closing the gap proves nearest
rounding on weight updates is the bottleneck. derived = final train loss.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import row, train_tiny_lm

STEPS = 400
LR = 1e-4  # small updates expose the cancellation/halting regime


def run(*, device=None) -> dict:
    results, us = {}, {}
    for pol in ("fp32", "bf16_standard", "bf16_master"):
        _, final, us[pol] = train_tiny_lm(pol, steps=STEPS, lr=LR, device=device)
        results[pol] = final
        row(f"table3_lm_{pol}", us[pol], f"final_loss={final:.4f}")
    gap_std = results["bf16_standard"] - results["fp32"]
    gap_abl = results["bf16_master"] - results["fp32"]
    row("table3_gap_standard_vs_fp32", 0.0, f"{gap_std:+.4f}")
    row("table3_gap_ablation_vs_fp32", 0.0, f"{gap_abl:+.4f}")
    return {"lm": results, "us": us, "gap_standard": gap_std, "gap_ablation": gap_abl}
