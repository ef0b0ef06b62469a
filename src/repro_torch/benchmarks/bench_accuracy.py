"""Table 4 — 16-bit-FPU training matches 32-bit with SR / Kahan (port of
``benchmarks/bench_accuracy.py``).

LM (AdamW, BERT-stand-in) + DLRM (SGD) under fp32 / standard / SR / Kahan.
derived = final loss (LM) or AUC (DLRM); the DLRM rows carry µs per step
where the reference writes 0.0. The LM runs and the DLRM runs are also
callable apart (``run_lm`` on some policies, ``run_dlrm``; ``gaps`` prints
the gap rows of their merged results), so that a caller may run them in
processes of their own.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import row, train_dlrm, train_tiny_lm

POLICIES = ("fp32", "bf16_standard", "bf16_sr", "bf16_kahan")


def run_lm(*, device=None, policies=POLICIES) -> dict:
    lm, lm_us = {}, {}
    for pol in policies:
        _, final, lm_us[pol] = train_tiny_lm(pol, steps=400, lr=1e-4, device=device)
        lm[pol] = final
        row(f"table4_lm_{pol}", lm_us[pol], f"final_loss={final:.4f}")
    return {"lm": lm, "lm_us": lm_us}


def run_dlrm(*, device=None) -> dict:
    dl, dl_us, dl_losses = {}, {}, {}
    for pol in POLICIES:
        dl_losses[pol], auc, _, dl_us[pol] = train_dlrm(pol, steps=400, device=device)
        dl[pol] = auc
        row(f"table4_dlrm_{pol}", dl_us[pol], f"auc={auc:.4f}")
    return {"dlrm": dl, "dlrm_us": dl_us, "dlrm_losses": dl_losses}


def gaps(res: dict) -> dict:
    """Print the gap rows of the LM and DLRM runs' merged results; returns
    them."""
    lm, dl = res["lm"], res["dlrm"]
    row("table4_lm_gap_sr_vs_fp32", 0.0, f"{lm['bf16_sr'] - lm['fp32']:+.4f}")
    row("table4_lm_gap_kahan_vs_fp32", 0.0, f"{lm['bf16_kahan'] - lm['fp32']:+.4f}")
    row("table4_lm_gap_standard_vs_fp32", 0.0,
        f"{lm['bf16_standard'] - lm['fp32']:+.4f}")
    row("table4_dlrm_gap_sr_vs_fp32", 0.0, f"{dl['bf16_sr'] - dl['fp32']:+.4f}")
    row("table4_dlrm_gap_kahan_vs_fp32", 0.0,
        f"{dl['bf16_kahan'] - dl['fp32']:+.4f}")
    return res


def run(*, device=None) -> dict:
    return gaps({**run_lm(device=device), **run_dlrm(device=device)})
