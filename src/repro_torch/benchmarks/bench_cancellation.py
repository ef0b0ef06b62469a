"""Fig 9 — fraction of non-zero weight updates cancelled by nearest
rounding, measured on the DLRM embedding tables over training (port of
``benchmarks/bench_cancellation.py``).
derived = cancellation fraction early vs late (should rise)."""
from __future__ import annotations

from repro_torch.benchmarks.common import row, train_dlrm


def run(*, device=None) -> dict:
    _, auc, frac, us = train_dlrm("bf16_standard", steps=300, lr=1.0, lr_decay=True,
                                  record_cancellation=True, device=device)
    early = sum(frac[:3]) / 3
    late = sum(frac[-3:]) / 3
    row("fig9_dlrm_cancel_frac_early", us, f"{early:.3f}")
    row("fig9_dlrm_cancel_frac_late", 0.0, f"{late:.3f}")
    row("fig9_cancel_rises", 0.0, str(late >= early))
    return {"early": early, "late": late, "fractions": frac, "auc": auc, "us": us}
