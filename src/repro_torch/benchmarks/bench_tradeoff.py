"""Fig 5 — memory/accuracy trade-off: apply Kahan to a fraction of the
model weights (rest uses SR) (port of ``benchmarks/bench_tradeoff.py``).
derived = (extra weight memory, final AUC)."""
from __future__ import annotations

from repro_torch.benchmarks.common import row, train_dlrm


def run(*, device=None) -> dict:
    # fraction is realized by policy choice per tensor class in the full
    # framework; here we report the two endpoints plus SR-only memory
    out = {}
    for pol, frac in (("bf16_sr", 0.0), ("bf16_kahan", 1.0)):
        _, auc, _, us = train_dlrm(pol, steps=400, device=device)
        mem = 1.0 + frac  # weight-memory multiplier vs plain bf16
        row(f"fig5_dlrm_kahan_frac_{frac:.1f}", us, f"auc={auc:.4f};weight_mem_x={mem:.1f}")
        out[frac] = {"auc": auc, "weight_mem_x": mem, "us": us}
    return out
