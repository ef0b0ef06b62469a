#!/usr/bin/env python3
"""The paged pool under a data axis alone on one GPU (``chip_smoke.py``'s
dp-paged part, ROADMAP A12 item 3).

    python3 tools/port_dp_paged.py [--cpu] [--cost]

Builds the kernels from this checkout, then runs side by side, with
nothing else on the card or the host: full-width qwen2.5-3b at
``TP_LAYERS`` served paged (tp (b)'s stream and pool: 10 requests, 32
pages of 16, chunk 1 and 32) on 2 data x 1 model ranks and on 2 x 2,
sharing the card over gloo, the page rows sharded over the data ranks;
and tp (b) itself (1 x 2 paged, the ``cut`` launch), whose tokens 2 x 2
must equal. Then the part's checks and the paged kernel at its shapes
(``chip_smoke.phase_dp_paged``), printing ms per eager step, the page
exchange's collectives, bytes, ms and host-copy ms per step, pool MiB and
peak GiB per rank beside the card's name and power limit. ``--cpu``
rehearses the launches and checks on the CPU at the reduced config.
``--cost`` then measures what the part's launches add to the smoke's
phase 19 (tp-hybrid, ``chip_smoke.hyb_runs``): phase 19's five launches
alone and with the part's two beside them, in turns (alone, with, with,
alone), printing each run's wall and its launches' walls and the mean
difference. Exits non-zero if a check fails.
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
    run = CS.hyb_runs(CS.DP_LAUNCHES + (("cut", 2),), rehearsal=rehearsal)
    print(f"[port_dp_paged] tp (b) beside the part: launch wall {run['cut'][1]:.1f}s",
          flush=True)
    dp = CS.phase_dp_paged(card, run, run["cut"][0][0]["paged"], rehearsal=rehearsal)
    print(f"[port_dp_paged] launches {dp['launches']}, paged kernel at the part's shapes "
          f"within {dp['max_abs_err']:.3e} of plain, in {time.perf_counter() - t0:.1f}s on "
          f"{card}", flush=True)
    if "--cost" in sys.argv:
        walls = {"alone": [], "with": []}
        for tag in ("alone", "with", "with", "alone"):
            names = CS.HYB_LAUNCHES + (CS.DP_LAUNCHES if tag == "with" else ())
            t = time.perf_counter()
            run = CS.hyb_runs(names, rehearsal=rehearsal)
            walls[tag].append(time.perf_counter() - t)
            print(f"[port_dp_paged] phase 19 {tag} the part: {walls[tag][-1]:.1f}s; launch "
                  "walls " + ", ".join(f"{n} {run[n][1]:.1f}s" for n, _ in names), flush=True)
        mean = {tag: sum(w) / len(w) for tag, w in walls.items()}
        print(f"[port_dp_paged] the part adds {mean['with'] - mean['alone']:.1f}s to phase 19 "
              f"(alone {[round(w, 1) for w in walls['alone']]}, with "
              f"{[round(w, 1) for w in walls['with']]}) on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
