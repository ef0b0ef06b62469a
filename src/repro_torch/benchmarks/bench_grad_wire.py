"""Gradient-wire transports on a mesh with a model axis: bytes per step on
the wire and µs per step (port of ``benchmarks/bench_grad_wire.py``).

The claim the compressed wire exists for: SR-to-bf16 with error feedback
halves the gradient bytes on the pod axis against an f32 reduction. The
setup is the reference's — reduced qwen2.5-3b, ``bf16_sr``, AdamW with β₂
0.997, constant lr 1e-3, batch 8 × 32, ``attn_chunk`` 32 — on 8 ranks
through :mod:`repro_torch.launch.dist_launch` (gloo; on a card the 8
ranks share it): 4 data × 2 model (the compressed wire rides ``data``)
and 2 pod × 2 data × 2 model, each with the fp32 and the compressed wire.
Each rank holds its tensor-parallel shards, so its wire carries its
shards' gradients.

Rows (process 0's):

* ``grad_wire_<wire>_<pods>pod_step`` — µs per step; ``wire_bytes`` and
  ``carrier`` the wire's bytes per step by carrier dtype from the
  transport's ``WireStats``: the explicit wire reductions the reference
  counts in its lowered module. The step's f32 mean over the data axes the
  wire does not reduce (GSPMD's, inside the reference's backward, with no
  collective of its own in that module) and the model axis's own
  collectives (``AxisStats``) are not counted, as the reference counts
  neither; with no wire (fp32 on one pod) the row says
  ``implicit-gspmd``, as the reference's. ``payload_bytes`` is
  ``CompressedWire.payload_bytes`` of the whole parameter tree, as the
  reference computes it (the wire bytes for the fp32 wire). The
  reference's ``rs_fallbacks`` label reads XLA's optimised module, so the
  rows say ``not_ported=ROADMAP_A6``, as the ``grad_wire_sweep_hlo_*``
  rows do.
* ``grad_wire_pod_bytes_ratio`` — fp32 ÷ compressed wire bytes on the
  2-pod mesh; asserted ≥ 1.9, as the reference asserts.

``smoke=True`` runs the 2-pod pair only, 2 timed steps each (5 in full).
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

RANKS = 8
RATIO_BAR = 1.9
_SHORT = {"float32": "f32", "bfloat16": "bf16", "float16": "f16", "float64": "f64"}


def _cases(smoke: bool) -> list[tuple[int, str]]:
    cases = [(2, "fp32"), (2, "compressed")]
    return cases if smoke else [(1, "fp32"), (1, "compressed")] + cases


def _worker(out: str, device: str, smoke: bool) -> None:
    """One rank: every case's steps; process 0 writes ``out``."""
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
        policy = get_policy("bf16_sr")
        cfg = R.get_config("qwen2.5-3b").reduced()
        batch = next(lm_batches(cfg.vocab, 8, 32, seed=1, device=device))
        iters = 2 if smoke else 5
        result = []
        for pods, wire in _cases(smoke):
            mesh = make_local_mesh(4 // pods, 2, pods=pods)
            params = R.init(cfg, 0, policy.param_dtype, device=device)
            pl = PT.Placement()
            pspecs = PT.param_specs(params, cfg, mesh, pl)
            opt = adamw(policy, b2=0.997)
            tr = TR.make_transport(mesh=mesh, placement=pl, pspecs=pspecs, wire=wire)
            payload = tr.payload_bytes(params) if hasattr(tr, "payload_bytes") else None
            state = make_train_state(F.shard_state(params, pspecs, mesh), opt, transport=tr)
            del params
            step = make_train_step(cfg, policy, opt, constant(1e-3), attn_chunk=32,
                                   transport=tr, mesh=mesh)
            state, m = step(state, batch, 0)          # warm
            float(m["loss"])
            before = tr.stats.wire_bytes_by_dtype()
            _sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                state, m = step(state, batch, 0)
            float(m["loss"])
            _sync()
            us = (time.perf_counter() - t0) / iters * 1e6
            after = tr.stats.wire_bytes_by_dtype()
            wb = {_SHORT[k]: (n - before.get(k, 0)) // iters for k, n in after.items()
                  if n - before.get(k, 0)}
            result.append({"pods": pods, "wire": wire, "us": us, "wire_bytes": wb,
                           "payload": payload, "loss": float(m["loss"])})
            del state, step, tr, opt
        if MH.is_primary():
            Path(out).write_text(json.dumps(result))
    finally:
        MH.shutdown()


def run(*, smoke: bool = False, device=None) -> dict:
    dev = str(resolve_device(device))
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "grad_wire.json"
        procs = DL.launch([sys.executable, "-m", "repro_torch.benchmarks.bench_grad_wire",
                           "--worker", str(out), dev, "smoke" if smoke else "full"], RANKS,
                          env=dict(os.environ, OMP_NUM_THREADS="1"), log_dir=tmp)
        codes = DL.wait(procs, timeout=1200)
        if any(codes):
            logs = "".join((Path(tmp) / f"rank{i}.log").read_text()[-1500:]
                           for i in range(RANKS))
            raise RuntimeError(f"grad_wire ranks exited {codes}: {logs}")
        res = json.loads(out.read_text())
    bytes_2pod = {}
    for case in res:
        total = sum(case["wire_bytes"].values())
        by = "+".join(f"{dt}:{b}" for dt, b in sorted(case["wire_bytes"].items()))
        payload = case["payload"] if case["payload"] is not None else total
        row(f"grad_wire_{case['wire']}_{case['pods']}pod_step", case["us"],
            f"wire_bytes={total} carrier={by or 'implicit-gspmd'} payload_bytes={payload} "
            f"not_ported=ROADMAP_A6")
        if case["pods"] == 2:
            bytes_2pod[case["wire"]] = total
    ratio = bytes_2pod["fp32"] / max(bytes_2pod["compressed"], 1)
    row("grad_wire_pod_bytes_ratio", 0.0,
        f"{ratio:.3f}x fp32={bytes_2pod['fp32']} compressed={bytes_2pod['compressed']}")
    assert ratio >= RATIO_BAR, f"compressed pod wire saves only {ratio:.2f}x"
    return {"cases": res, "ratio": ratio}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2], sys.argv[3], sys.argv[4] == "smoke")
