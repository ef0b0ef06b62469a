#!/usr/bin/env python3
"""Train-step time of the PyTorch port on one GPU.

    python3 tools/port_train_steps.py [--src PATH] [--steps N]

Trains full-width qwen2.5-3b as ``chip_smoke.py``'s train phase does
(random weights from seed 0, ``bf16_sr_kahan --fused-update``, batch 2 ×
2048, lr 3e-3) through the launcher's ``build`` and ``train``, with no
checkpoint directory, and prints the host wall of every step and the mean
of steps 2 on. A step's wall runs from the loop's pull of its batch to the
pull of the next (the last: to the loop's return); each step ends in the
loop's read of its metrics, a sync. ``--src`` imports ``repro_torch`` from
another tree's ``src`` (an unpacked parent commit, to compare two trees in
one run); this tree's ``chip_smoke.py`` supplies the flags. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch to run")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the port on a GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import dataclasses

    import chip_smoke as CS
    import repro_torch
    from repro_torch.launch import train as LT

    card = CS.phase_card()
    print(f"[train-steps] repro_torch from {Path(repro_torch.__file__).parent}")
    targs = LT.parse_args(CS.TRAIN_ARGV + ["--steps", str(args.steps)])
    run = LT.build(targs)
    pulls = []

    def batches(start_step):
        stream = run.batches(start_step)
        while True:
            batch = next(stream)
            pulls.append(time.perf_counter())
            yield batch

    torch.cuda.synchronize()
    state, info = LT.train(targs, dataclasses.replace(run, batches=batches), log=lambda _: None)
    pulls.append(time.perf_counter())
    walls = [1e3 * (b - a) for a, b in zip(pulls, pulls[1:])]
    steady = walls[2:]
    print(f"[train-steps] on {card}: {args.steps} steps, final loss "
          f"{info['history'][-1]['loss']:.4f}; step walls {[round(w, 1) for w in walls]} ms; "
          f"steps 2-{args.steps - 1}: {sum(steady) / len(steady):.1f} ms per step "
          f"(median {sorted(steady)[len(steady) // 2]:.1f}), "
          f"{targs.batch * targs.seq / (sum(steady) / len(steady)) * 1e3:.0f} tokens/s")


if __name__ == "__main__":
    main()
