#!/usr/bin/env python3
"""The paper's DLRM (Table 4) and least-squares (Fig 2) rows from the
reference's starting draws at seeds 0-3 (ROADMAP C19).

    python3 tools/port_paper_seeds.py [--cpu] [--seeds 0,1,2,3]

Per seed s: ``common.train_dlrm`` at Table 4's settings (400 SGD steps,
batch 128) under fp32, bf16_standard, bf16_sr and bf16_kahan from
``dlrm_init(PRNGKey(s))`` on the click stream of seed s + 1, printing each
AUC and the gaps to fp32; Fig 2's three least-squares runs (6000 batch-1
SGD steps) on ``make_dataset(PRNGKey(s))`` with sample i drawn by
``randint(fold_in(PRNGKey(s + 1), i))`` (seed 0 is the reference's own
Fig 2), printing the final MSEs and the floor ratios. The reference's rows
at seed 0: fp32 AUC 0.605 (Table 4), Fig 2's nearest-on-updates floor
14.5x exact. Runs on the card (``--cpu``: on the CPU); prints the card's
name and power limit.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    from repro_torch.benchmarks import bench_theory as BT
    from repro_torch.benchmarks.bench_accuracy import POLICIES
    from repro_torch.benchmarks.common import train_dlrm
    from repro_torch.core import jrandom
    from repro_torch.models.lstsq import make_dataset
    device = "cpu" if "--cpu" in sys.argv else "cuda"
    seeds = [0, 1, 2, 3]
    if "--seeds" in sys.argv:
        seeds = [int(s) for s in sys.argv[sys.argv.index("--seeds") + 1].split(",")]
    if device == "cuda":
        import chip_smoke as CS
        card = CS.phase_card()
        CS.phase_build()
    else:
        card = "the CPU"
    t0 = time.perf_counter()
    for s in seeds:
        auc = {p: train_dlrm(p, steps=400, seed=s, device=device)[1] for p in POLICIES}
        print(f"[paper-seeds] seed {s} table4 DLRM AUC on {card}: "
              + ", ".join(f"{p} {a:.4f}" for p, a in auc.items())
              + f"; gaps to fp32: sr {auc['bf16_sr'] - auc['fp32']:+.4f}, kahan "
              f"{auc['bf16_kahan'] - auc['fp32']:+.4f}, standard "
              f"{auc['bf16_standard'] - auc['fp32']:+.4f}", flush=True)
    for s in seeds:
        X, y, _ = make_dataset(jrandom.PRNGKey(s), n=512, d=10, device=device)
        idx = BT.sample_indices(6000, 512, seed=s + 1).to(device)
        mse = {m: BT.train(X, y, idx, m) for m in ("exact", "updates", "fwdbwd")}
        print(f"[paper-seeds] seed {s} fig2 on {card}: mse exact {mse['exact']:.4e}, nearest "
              f"on updates {mse['updates']:.4e} ({mse['updates'] / mse['exact']:.2f}x), on "
              f"fwd/bwd {mse['fwdbwd']:.4e} ({mse['fwdbwd'] / mse['exact']:.4f}x)", flush=True)
    print(f"[paper-seeds] {time.perf_counter() - t0:.1f}s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
