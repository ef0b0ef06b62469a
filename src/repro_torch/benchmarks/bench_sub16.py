"""Fig 10 — below 16-bit (bf14/bf12/bf10, 8 exponent bits kept) (port of
``benchmarks/bench_sub16.py``). derived = final loss per format with SR
and with Kahan.

``smoke=True`` runs one low-step cell (bf12 + SR) so the sub-16 storage
path is exercised cheaply.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import row, train_dlrm


def run(*, smoke: bool = False, device=None) -> dict:
    cells = [("bf12", "sr")] if smoke else [
        (fam, tech) for fam in ("bf14", "bf12", "bf10")
        for tech in ("sr", "kahan")]
    steps = 40 if smoke else 300
    out = {}
    for fam, tech in cells:
        losses, auc, _, us = train_dlrm(f"{fam}_{tech}", steps=steps, device=device)
        final = sum(losses[-10:]) / 10
        row(f"fig10_dlrm_{fam}_{tech}", us, f"auc={auc:.4f};final_loss={final:.4f}")
        out[f"{fam}_{tech}"] = {"auc": auc, "final_loss": final, "us": us}
    return out
