#!/usr/bin/env python3
"""Where the paper harnesses' steps spend their time, on one GPU.

    python3 tools/port_paper_steps.py [--steps N]

For each policy, runs ``repro_torch.benchmarks.common.train_tiny_lm`` (the
reduced qwen2.5-3b, batch 8 × 32, the sections' settings) and
``train_dlrm`` (batch 128) as the paper's sections do, and prints per
step: the host wall (the harness's own clock, no profiler), the CUDA
kernels launched and their device time (``torch.profiler``, CUDA activity
only: two profiled runs of N and 2N steps, so their difference holds N
steps and no set-up), and the device's idle share, 1 − device time / wall,
unclamped: the wall and the device time come from separate runs, so a
negative share says the two runs differ.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LM_POLICIES = ("fp32", "bf16_standard", "bf16_sr", "bf16_kahan", "fp16_sr")
DLRM_POLICIES = ("fp32", "bf16_standard", "bf16_sr", "bf16_kahan", "bf12_sr")


def _kernels(prof) -> tuple[int, float]:
    """Kernel count and device ms of a profile."""
    n, us = 0, 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            n += e.count
            us += getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0)
    return n, us / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the port on a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.benchmarks import common as C

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card)
    n = args.steps
    runs = [("lm", p, lambda p, k: C.train_tiny_lm(p, steps=k, lr=1e-4, device="cuda"))
            for p in LM_POLICIES]
    runs += [("dlrm", p, lambda p, k: C.train_dlrm(p, steps=k, device="cuda"))
             for p in DLRM_POLICIES]
    for model, policy, fn in runs:
        fn(policy, 3)                                   # warm: kernels built, caches
        wall_ms = fn(policy, 6 * n)[-1] / 1e3
        counts = []
        for k in (n, 2 * n):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(policy, k)
                torch.cuda.synchronize()
            counts.append(_kernels(prof))
        kernels = (counts[1][0] - counts[0][0]) / n
        device_ms = (counts[1][1] - counts[0][1]) / n
        print(f"[paper-steps] {model} {policy} on {card}: {wall_ms:.2f} ms per step host wall "
              f"({6 * n} steps), {kernels:.0f} kernels and {device_ms:.3f} ms device time per "
              f"step (profiled), device idle {1 - device_ms / wall_ms:.1%}", flush=True)


if __name__ == "__main__":
    main()
