#!/usr/bin/env python3
"""The MoE and Mamba families on the model axis alone on one GPU
(``chip_smoke.py``'s tp-families phase, ROADMAP A12 item 1).

    python3 tools/port_tp_families.py [--cpu]

Builds the kernels from this checkout, runs the phase's launches with
nothing else on the card or the host (``chip_smoke.tp_families_launches``:
mixtral-8x22b at 2 layers, llama4-scout-17b-a16e at 1 and falcon-mamba-7b
at 8 served on 1 data x 2 model ranks sharing the card over gloo; mixtral
at 1 layer and falcon-mamba at 2 trained 3 steps beside one process),
then its checks (``chip_smoke.phase_tp_families``), printing ms per step,
the model axis's collectives, their ms and host-copy ms, and peak GiB per
rank beside the card's name and power limit. ``--cpu`` rehearses it on
the CPU at the reduced configs. Exits non-zero if a check fails.
"""
import os
import shutil
import sys
import tempfile
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
    root = Path(tempfile.mkdtemp(prefix="repro-tp-families-"))
    kw = dict(device="cpu", reduced=True) if rehearsal else {}
    run = {"root": root}
    try:
        CS.tp_families_launches(run, lambda name, n: CS._tp_start(root, name, n, **kw))
        launches = CS.phase_tp_families(card, run, rehearsal=rehearsal)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[port_tp_families] launches {launches} in {time.perf_counter() - t0:.1f}s on "
          f"{card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
