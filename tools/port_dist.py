#!/usr/bin/env python3
"""The port's data-parallel phase alone on one GPU (``chip_smoke.py``'s
dist phase without the others), then the runner's ``grad_wire_sweep``.

    python3 tools/port_dist.py

Builds the kernels from this checkout, runs ``chip_smoke.phase_dist``
(the one-replica bf16 wire at full width in a 1-rank NCCL group; 2 ranks
sharing the card over gloo through ``repro_torch.launch.dist_launch``)
and ``python -m repro_torch.benchmarks.run --only grad_wire_sweep``.
Without the train phase's reference the one-replica run's losses are not
compared with a run without a transport. Exits non-zero if a check fails.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def main() -> int:
    import chip_smoke as CS
    t0 = time.perf_counter()
    card = CS.phase_card()
    CS.phase_build()
    print(f"[port_dist] launches {CS.phase_dist(card, float('nan'), None)}", flush=True)
    sweep = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run", "--only",
                            "grad_wire_sweep"], cwd=ROOT,
                           env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    print(f"[port_dist] {time.perf_counter() - t0:.1f}s on {card}")
    return sweep.returncode


if __name__ == "__main__":
    sys.exit(main())
