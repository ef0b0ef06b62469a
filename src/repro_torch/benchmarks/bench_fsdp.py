"""DP against FSDP: bytes of params and optimizer state per rank, and µs
per step (port of ``benchmarks/bench_fsdp.py``).

The memory claim FSDP exists for here: Algorithm 5 (Kahan) keeps 8 bytes
of bf16 state per weight (w, m, v, c), and FSDP shards all of it over a
data axis, so the bytes per rank shrink by about the axis size while the
step computes the same update. The setup is the reference's — reduced
qwen2.5-3b, ``bf16_sr_kahan``, AdamW with β₂ 0.997, batch 8 × 32 — on a
mesh of 2 data × 2 fsdp. The reference's mesh adds 2 model (tensor
parallelism; FSDP beside it is ROADMAP A13), which both of its placements shard alike, so
its ratio compares the FSDP axis alone, as this one does: 4 ranks
through :mod:`repro_torch.launch.dist_launch` (gloo; on a card the 4 ranks
share it), each running the data-parallel placement then the FSDP one.

Rows: ``fsdp_compare_dp_step`` and ``fsdp_compare_fsdp_step`` (µs per
step, the bytes per rank in ``derived``) and
``fsdp_vs_dp_state_bytes_ratio``.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

from repro_torch import resolve_device
from repro_torch.benchmarks.common import _sync, row
from repro_torch.launch import dist_launch as DL

RANKS = 4
STEPS = 5


def _worker(out: str, device: str) -> None:
    """One rank: both placements on the 2 data x 2 fsdp mesh; process 0
    writes ``out`` (bytes per rank and µs per step of each)."""
    import torch

    from repro_torch.core.policy import get_policy
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.dist import fsdp as F
    from repro_torch.dist import multihost as MH
    from repro_torch.dist import partition as PT
    from repro_torch.dist import transport as TR
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import registry as R
    from repro_torch.optim import adamw, constant
    from repro_torch.train.step import make_train_step
    from repro_torch.train.train_state import make_train_state

    torch.set_num_threads(1)
    MH.initialize(device=device, backend="gloo")
    try:
        policy = get_policy("bf16_sr_kahan")
        cfg = R.get_config("qwen2.5-3b").reduced()
        mesh = make_local_mesh(2, fsdp=2)
        batch = next(lm_batches(cfg.vocab, 8, 32, seed=1, device=device))
        result = {}
        for tag, fsdp in (("dp", False), ("fsdp", True)):
            params = R.init(cfg, 0, policy.param_dtype, device=device)
            placement = PT.default_placement(mesh, fsdp=fsdp)
            pspecs = PT.param_specs(params, cfg, mesh, placement)
            params = F.shard_state(params, pspecs, mesh)
            opt = adamw(policy, b2=0.997)
            tr = TR.make_transport(mesh=mesh, placement=placement, pspecs=pspecs)
            state = make_train_state(params, opt, transport=tr)
            nbytes = F.per_device_bytes((state.params, state.opt_state))
            step = make_train_step(cfg, policy, opt, constant(1e-3), attn_chunk=32,
                                   transport=tr, mesh=mesh)
            state, m = step(state, batch, 0)          # warm
            float(m["loss"])
            _sync()
            t0 = time.perf_counter()
            for _ in range(STEPS):
                state, m = step(state, batch, 0)
            float(m["loss"])
            _sync()
            result[tag] = {"bytes": nbytes, "us": (time.perf_counter() - t0) / STEPS * 1e6}
            del state, params
        if MH.is_primary():
            Path(out).write_text(json.dumps(result))
    finally:
        MH.shutdown()


def run(*, device=None) -> dict:
    dev = str(resolve_device(device))
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "fsdp.json"
        procs = DL.launch([sys.executable, "-m", "repro_torch.benchmarks.bench_fsdp",
                           "--worker", str(out), dev], RANKS,
                          env=dict(os.environ, OMP_NUM_THREADS="1"), log_dir=tmp)
        codes = DL.wait(procs, timeout=600)
        if any(codes):
            logs = "".join((Path(tmp) / f"rank{i}.log").read_text()[-1500:]
                           for i in range(RANKS))
            raise RuntimeError(f"fsdp ranks exited {codes}: {logs}")
        res = json.loads(out.read_text())
    for tag in ("dp", "fsdp"):
        row(f"fsdp_compare_{tag}_step", res[tag]["us"],
            f"state_bytes_per_device={res[tag]['bytes']}")
    ratio = res["dp"]["bytes"] / res["fsdp"]["bytes"]
    row("fsdp_vs_dp_state_bytes_ratio", 0.0, f"{ratio:.3f}x")
    return {**res, "ratio": ratio}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2], sys.argv[3])
