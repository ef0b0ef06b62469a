#!/usr/bin/env python3
"""The port's FSDP runs alone on one GPU (``chip_smoke.py``'s multi-rank
dist runs, the FSDP checks among them), then FSDP at full depth.

    python3 tools/port_fsdp.py

Builds the kernels from this checkout and runs ``chip_smoke._dist_two_ranks``:
the Philox shard entry's checks and time, the 2-rank data-parallel and
FSDP runs over gloo on this card at full width cut to 2 layers (non-fused
FSDP-2 == DP-2 bitwise, a shard's fused AdamW == its plain version, state
bytes, SIGTERM and resume, the 4-rank pods 2 x fsdp 2 launch). Then, with
nothing else on the card or the host, one 2-rank launch that times DP-2
against FSDP-2 at that cut, fused and non-fused, each in the order DP,
FSDP, FSDP, DP (the smoke's step walls are taken beside its 4-rank
launch); and the runner's ``fsdp_memory`` section (4 ranks sharing the
card). Then the run
``chip_smoke.py`` has no time for: full-width qwen2.5-3b at its whole 36
layers, ``bf16_sr_kahan --fused-update``, batch 1 x 2048 per rank, 3 steps,
on 2 FSDP ranks sharing the card, and the same as DP-2, which may not fit
(its failure is reported, not raised). Prints s per step, bytes moved and
peak GiB per rank, with the card's name and power limit. Exits non-zero if
a check of the first part, the section, or the FSDP-2 full-depth run
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

FULL_ARGV = ["--arch", "qwen2.5-3b", "--policy", "bf16_sr_kahan", "--fused-update",
             "--batch", "2", "--seq", "2048", "--steps", "3", "--lr", "3e-3", "--seed", "0",
             "--device", "cuda", "--dist-backend", "gloo"]


def full_depth(card: str, root: Path, name: str, topology: list) -> bool:
    """One 2-rank run at the whole depth; prints its numbers, or the tail of
    the ranks' logs when it fails. True if it ran."""
    import chip_smoke as CS
    job = dict(argv=FULL_ARGV + topology, out=str(root / name), layers=None, gather=False)
    proc, t0, tag, log_dir, n = CS._dist_start({"runs": [job]}, root, name)
    try:
        _, err = proc.communicate(timeout=1500)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        tails = "\n".join((log_dir / f"rank{i}.log").read_text()[-1500:] for i in range(n))
        print(f"[port_fsdp] {name} ({' '.join(topology)}) failed on {card} after {wall:.1f} s "
              f"(exit {proc.returncode}):\n{tails}{err[-1500:]}", flush=True)
        return False
    for r in range(n):
        res = CS._dist_result(root, name, r)
        steps = len(res["losses"])
        per = lambda d: {k: v // steps for k, v in d.items()}  # noqa: E731
        fs = res["fsdp"]
        print(f"[port_fsdp] {name} rank {r} on {card}: 36 layers, {' '.join(topology)}, "
              f"{res['wire']}; losses {[round(x, 4) for x in res['losses']]}; step walls "
              f"{[round(x, 2) for x in res['step_s']]} s; gather "
              f"{per(fs.get('gather_bytes', {}))} B/step, reduce-scatter "
              f"{fs.get('scatter_bytes', 0) // steps} B/step, wire {per(res['wire_bytes'])} "
              f"B/step; host copies {res['host_copy_s'] / steps:.2f} s/step; state "
              f"{fs.get('state_bytes', 0) / 1e9:.3f} GB; peak {res['peak_gib']:.2f} GiB; "
              f"launches {res['launches']}; launch wall {wall:.1f} s", flush=True)
    return True


def alone(card: str, root: Path) -> None:
    """DP-2 against FSDP-2 at the smoke's cut (``chip_smoke.DIST_ARGV``, 3
    steps, the fp32 wire), one launch, nothing beside it: fused and
    non-fused, each DP, FSDP, FSDP, DP. Prints each run's step walls and
    the mean of steps 1-2 (step 0 builds and warms)."""
    import chip_smoke as CS
    order = [("dp", CS.DIST_TWO_RANKS), ("fsdp", CS.FSDP_TWO_RANKS),
             ("fsdp", CS.FSDP_TWO_RANKS), ("dp", CS.DIST_TWO_RANKS)]
    runs = []
    for kind, base in (("fused", CS.DIST_ARGV), ("plain", CS.FSDP_PLAIN_ARGV)):
        for i, (tag, topology) in enumerate(order):
            runs.append((f"{tag}-{kind}-{i}", base + topology))
    launch = CS._dist_start({"runs": [dict(argv=argv, out=str(root / name))
                                      for name, argv in runs]}, root, "alone")
    wall = CS._dist_wait(launch)
    steady = {}
    for name, _ in runs:
        res = CS._dist_result(root, name, 0)
        steady[name] = sum(res["step_s"][1:]) / len(res["step_s"][1:])
        print(f"[port_fsdp] alone {name} on {card}: step walls "
              f"{[round(x, 4) for x in res['step_s']]} s, steps 1-2 {steady[name]:.4f} s; "
              f"host copies {res['host_copy_s'] / len(res['losses']):.4f} s/step; peak "
              f"{res['peak_gib']:.2f} GiB per rank", flush=True)
    for kind in ("fused", "plain"):
        dp = [v for k, v in steady.items() if k.startswith(f"dp-{kind}")]
        fs = [v for k, v in steady.items() if k.startswith(f"fsdp-{kind}")]
        print(f"[port_fsdp] alone {kind} on {card}: DP-2 {[round(x, 4) for x in dp]} s, FSDP-2 "
              f"{[round(x, 4) for x in fs]} s per step (steps 1-2); FSDP / DP "
              f"{sum(fs) / sum(dp):.4f}; launch wall {wall:.1f} s", flush=True)


def main() -> int:
    import chip_smoke as CS
    t0 = time.perf_counter()
    card = CS.phase_card()
    CS.phase_build()
    print(f"[port_fsdp] launches {CS._dist_two_ranks(card)}", flush=True)
    root = Path(tempfile.mkdtemp(prefix="repro-fsdp-"))
    try:
        alone(card, root)
        memory = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run", "--only",
                                 "fsdp_memory"], cwd=ROOT,
                                env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        ok = full_depth(card, root, "fsdp-36", ["--fsdp-parallel", "2"])
        full_depth(card, root, "dp-36", ["--data-parallel", "2"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[port_fsdp] {time.perf_counter() - t0:.1f}s on {card}")
    return 0 if ok and memory.returncode == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
