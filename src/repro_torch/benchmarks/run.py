"""Benchmark runner — one section per paper table/figure (port of
``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV rows under the reference's row
names. Usage::

    python -m repro_torch.benchmarks.run [--only fig2,table4] [--smoke] [--device cpu]

Runs on CUDA unless ``--device cpu``; without a card it raises. ``--smoke``
asks each section for its shrunken variant (sections without one run at
full size). Every section of the reference is listed; one not ported yet
fails naming the ROADMAP item that ports it. A section that raises is
reported and the remaining sections still run, but the run exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import sys
import time
import traceback

from repro_torch import resolve_device

# (section, module of repro_torch.benchmarks, or the ROADMAP item that ports it)
SECTIONS = [
    ("fig2_theory", "bench_theory"),
    ("table3_bottleneck", "bench_bottleneck"),
    ("table4_accuracy", "bench_accuracy"),
    ("fig5_tradeoff", "bench_tradeoff"),
    ("fig9_cancellation", "bench_cancellation"),
    ("fig10_sub16", "bench_sub16"),
    ("fig11_combined", "bench_combined"),
    ("fig12_fp16", "bench_fp16"),
    ("appB_kernels", "ROADMAP A6"),
    ("roofline", "ROADMAP A6"),
    ("fsdp_memory", "bench_fsdp"),       # 2 data x 2 fsdp on 4 ranks
    ("serve_batching", "ROADMAP A8"),
    ("grad_wire", "bench_grad_wire"),   # 4 data x 2 model, 2 pod x 2 data x 2 model: 8 ranks
    ("grad_wire_sweep", "bench_grad_wire_sweep"),
    ("decode_attn", "ROADMAP A8"),
]


def run_section(name: str, *, smoke: bool = False, device=None) -> dict:
    """Run one section in this process and return its numbers."""
    module = dict(SECTIONS)[name]
    if module.startswith("ROADMAP"):
        raise NotImplementedError(f"{name} is not ported yet ({module})")
    mod = importlib.import_module(f"repro_torch.benchmarks.{module}")
    kwargs = {"device": device}
    if smoke and "smoke" in inspect.signature(mod.run).parameters:
        kwargs["smoke"] = True
    return mod.run(**kwargs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated section prefixes to run")
    ap.add_argument("--smoke", action="store_true",
                    help="shrunken runs for sections that have one")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    only = args.only.split(",") if args.only else None
    print("name,us_per_call,derived", flush=True)
    failed = []
    for name, _ in SECTIONS:
        if only and not any(name.startswith(o) for o in only):
            continue
        t0 = time.time()
        try:
            run_section(name, smoke=args.smoke, device=device)
        except Exception as e:  # keep the suite going; report the failure
            traceback.print_exc()
            print(f"{name}_ERROR,0.0,{type(e).__name__}:{e}", file=sys.stderr)
            print(f"{name}_ERROR,0.0,{type(e).__name__}", flush=True)
            failed.append(name)
        print(f"# section {name} took {time.time() - t0:.1f}s", file=sys.stderr)
    if failed:
        print(f"# failed sections: {','.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
