#!/usr/bin/env python3
"""The RG-LRU hybrid and whisper on the model axis alone on one GPU
(``chip_smoke.py``'s tp-hybrid phase 19, ROADMAP A12 items 1b and 2).

    python3 tools/port_tp_hybrid.py [--cpu]

Builds the kernels from this checkout, holds the decode kernel at the
phase's per-rank shapes and ``qmatmul_f32`` at its row-parallel partials
against their plain versions, then runs the phase's launches with nothing
else on the card or the host (``chip_smoke.hyb_runs``, side by side:
recurrentgemma-2b at 6 layers and whisper-base whole served on 1 data x 2
model ranks sharing the card over gloo, recurrentgemma-2b at 3 layers on
1 x 4, recurrentgemma-2b at 3 layers and whisper-base trained 3 steps
beside one process), then its checks (``chip_smoke.phase_tp_hybrid``),
printing ms per step, the model axis's collectives, their ms and
host-copy ms, and peak GiB per rank beside the card's name and power
limit. ``--cpu`` rehearses the launches and checks on the CPU at the
reduced configs. Exits non-zero if a check fails.
"""
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def main() -> int:
    import chip_smoke as CS
    rehearsal = "--cpu" in sys.argv
    t0 = time.perf_counter()
    card = "CPU rehearsal" if rehearsal else CS.phase_card()
    if not rehearsal:
        CS.phase_build()
        CS.phase_kernel_hybrid(card)
        CS.phase_qmatmul_f32(card)
    launches = CS.phase_tp_hybrid(card, CS.hyb_runs(rehearsal=rehearsal),
                                  rehearsal=rehearsal)
    print(f"[port_tp_hybrid] launches {launches} in {time.perf_counter() - t0:.1f}s on "
          f"{card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
