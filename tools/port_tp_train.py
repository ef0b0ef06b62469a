#!/usr/bin/env python3
"""The port's training on the model axis alone on one GPU (``chip_smoke.py``'s
phase 17), then 1 data x 2 model at the whole depth, and the runner's
``grad_wire`` section.

    python3 tools/port_tp_train.py [--cpu]

Builds the kernels from this checkout, runs phase 17's launches with
nothing else on the card or the host (``chip_smoke.tp_train_launches``,
then its checks ``chip_smoke.phase_tp_train``: (a) 1 x 2 at full width
cut to 2 layers against one process, (b) the non-fused SR update on the
shards, (c) 2 x 2 through the bf16 wire and its checkpoint restored in
one process and under 1 x 2). Then the run ``chip_smoke.py`` has no time
for: full-width qwen2.5-3b at its whole 36 layers, ``bf16_sr_kahan
--fused-update``, batch 2 x 2048 (the train cell's), 3 steps, on 1 data x
2 model ranks sharing the card over gloo: ms per step, the model axis's
collectives, their ms and host-copy ms per step, weight and state bytes
and peak GiB per rank (FSDP-2 and DP-2 at this depth: ``tools/port_fsdp.py``).
Then the runner's ``grad_wire`` section alone (8 ranks sharing the
card). Every number is printed beside the card's name and
power limit. ``--cpu`` rehearses the first part on the CPU at the reduced
config. Exits non-zero if a check, the whole-depth run or the section
fails.
"""
import os
import shutil
import subprocess
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
    root = Path(tempfile.mkdtemp(prefix="repro-tp-train-"))
    kw = dict(device="cpu", reduced=True) if rehearsal else {}
    run = {"root": root}
    try:
        CS.tp_train_launches(run, lambda name, n: CS._tp_start(root, name, n, **kw))
        print(f"[port_tp_train] phase 17 launches {CS.phase_tp_train(card, run, rehearsal=rehearsal)}"
              f" in {time.perf_counter() - t0:.1f}s", flush=True)
        if rehearsal:
            return 0
        try:
            whole, wall = CS._tp_wait(CS._tp_start(root, "train-whole", 2))
        except SystemExit:
            print(f"[port_tp_train] the 36-layer 1 x 2 run failed on {card}", flush=True)
            return 1
        for res in whole:
            w = res["whole"]
            steady = w["step_s"][1:]
            print(f"[port_tp_train] whole rank {res['rank']} on {card}: qwen2.5-3b "
                  f"{res['n_layers']} layers, 1 x 2 over gloo, batch 2 x 2048, bf16_sr_kahan "
                  f"fused; losses {[round(x, 4) for x in w['losses']]}; step walls "
                  f"{[round(x, 3) for x in w['step_s']]} s, steps 1-2 "
                  f"{1e3 * sum(steady) / len(steady):.1f} ms per step; model-axis "
                  f"collectives {w['collectives']:.0f} per step, {1e3 * w['collective_s']:.1f} "
                  f"ms, of which host copies {1e3 * w['host_copy_s']:.1f} ms (steps 1-2); "
                  f"weights and state {res['bytes'] / 2**30:.3f} GiB; peak "
                  f"{w['peak_gib']:.2f} GiB; launches {w['launches']}; launch wall {wall:.1f}s",
                  flush=True)
        t1 = time.perf_counter()
        # the section alone (--only takes prefixes, and grad_wire_sweep has one)
        section = subprocess.run([sys.executable, "-c", "from repro_torch.benchmarks import run; "
                                  "run.run_section('grad_wire', device='cuda')"], cwd=ROOT,
                                 env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        print(f"[port_tp_train] grad_wire section on {card} (8 ranks sharing the card): "
              f"{time.perf_counter() - t1:.1f}s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[port_tp_train] {time.perf_counter() - t0:.1f}s on {card}")
    return section.returncode


if __name__ == "__main__":
    sys.exit(main())
