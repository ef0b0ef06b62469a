"""Fig 11 — SR and Kahan applied simultaneously (port of
``benchmarks/bench_combined.py``). derived = final metric."""
from __future__ import annotations

from repro_torch.benchmarks.common import row, train_dlrm, train_tiny_lm


def run(*, device=None) -> dict:
    _, final, lm_us = train_tiny_lm("bf16_sr_kahan", steps=400, lr=1e-4, device=device)
    row("fig11_lm_sr_kahan", lm_us, f"final_loss={final:.4f}")
    _, auc, _, dl_us = train_dlrm("bf16_sr_kahan", steps=400, device=device)
    row("fig11_dlrm_sr_kahan", dl_us, f"auc={auc:.4f}")
    return {"lm": final, "lm_us": lm_us, "dlrm": auc, "dlrm_us": dl_us}
