"""The runner's ``grad_wire_sweep`` section (its training rows) and its
``grad_wire`` section on the CPU.

* ``--smoke`` prints the reference's rows (the LM's fp32, bf12 and keep
  cells), each row's payload bytes, carrier and ratio equal to what the
  reference's sweep computes for the same wire, bf12's ratio ≥ 2.6, the
  losses finite and falling from the start (~6.7 at vocab 512).
* The full section's rows and its two assertions, with the training
  replaced by fixed losses: the ``_hlo`` rows name ROADMAP A6, and a keep
  cell outside ``TOL`` of fp32 fails the section.
* ``grad_wire --smoke`` (the 2-pod pair: 2 pod × 2 data × 2 model on 8
  gloo ranks) prints the reference's row names, each rank's wire bytes
  per step are its tensor-parallel shards' gradients at 4 bytes (fp32) or
  2 (bf16) per element, the payload is the whole tree's, and the pod
  bytes ratio is ≥ 1.9.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from benchmarks import bench_grad_wire_sweep as j_sweep
from repro.models import registry as JR
from repro_torch.benchmarks import bench_grad_wire_sweep as sweep
from repro_torch.benchmarks import run as runner
from repro_torch.dist import fsdp as F
from repro_torch.dist import partition as PT
from repro_torch.launch.mesh import Mesh
from repro_torch.models import registry as R
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent


def _rows(text):
    return {line.split(",")[0]: dict(kv.split("=") for kv in line.split(",")[2].split())
            for line in text.splitlines()[1:] if line.startswith("grad_wire_sweep")}


def test_smoke_rows_match_the_reference_accounting():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run", "--only",
                          "grad_wire_sweep", "--smoke", "--device", "cpu"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = _rows(out.stdout)
    assert list(rows) == ["grad_wire_sweep_lm_fp32", "grad_wire_sweep_lm_bf12",
                          "grad_wire_sweep_lm_bf12_keep"]
    probe = JR.init(JR.get_config("qwen2.5-3b").reduced(), jax.random.PRNGKey(0))
    base = None
    for label, wire, pol in [c for c in j_sweep.CELLS if c[0] in ("fp32", "bf12", "bf12_keep")]:
        payload, carrier = j_sweep._payload(j_sweep._make_transport(wire, pol), probe)
        base = base or payload
        got = rows[f"grad_wire_sweep_lm_{label}"]
        assert int(got["payload_bytes_per_step"]) == payload
        assert got["carrier"] == carrier
        assert got["ratio_vs_fp32"] == f"{base / payload:.3f}"
        assert 5.0 < float(got["final_loss"]) < 6.8 and got["tol"] == "0.15"
    assert float(rows["grad_wire_sweep_lm_bf12"]["ratio_vs_fp32"]) >= 2.6


def test_full_rows_and_assertions(monkeypatch, capsys):
    def fake(loss_of):
        return lambda tr, steps, dev: (loss_of(tr), 1.0)

    keep_loss = {"value": 1.0}
    monkeypatch.setattr(sweep, "_train_lm", fake(
        lambda tr: keep_loss["value"] if getattr(tr, "policy", None) else 1.0))
    monkeypatch.setattr(sweep, "_train_dlrm", fake(lambda tr: 0.5))
    out = sweep.run(device="cpu")
    rows = _rows("name\n" + capsys.readouterr().out)
    assert list(rows)[:12] == [f"grad_wire_sweep_{m}_{c[0]}" for m in ("lm", "dlrm")
                               for c in sweep.CELLS]
    assert [r for r in rows if "_hlo_" in r] == [
        f"grad_wire_sweep_hlo_{w}" for w in ("fp32", "bf16", "bf12", "e4m3")]
    assert all(rows[r]["not_ported"] == "ROADMAP_A6" for r in rows if "_hlo_" in r)
    assert out["dlrm_bf12"]["ratio_vs_fp32"] >= 2.6
    keep_loss["value"] = 1.2            # outside the LM's 0.15 of fp32's 1.0
    with pytest.raises(AssertionError, match="keep-policy loss"):
        sweep.run(device="cpu")


def test_grad_wire_section_on_eight_ranks():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run", "--only",
                          "grad_wire", "--smoke", "--device", "cpu"],
                         capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = {line.split(",")[0]: line.split(",")[2] for line in out.stdout.splitlines()
            if line.startswith("grad_wire_") and not line.startswith("grad_wire_sweep")}
    assert list(rows) == ["grad_wire_fp32_2pod_step", "grad_wire_compressed_2pod_step",
                          "grad_wire_pod_bytes_ratio"]
    # one rank's shards on the 2 pod x 2 data x 2 model mesh
    cfg = R.get_config("qwen2.5-3b").reduced()
    params = R.init(cfg, 0, device="cpu")
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2))
    local = sum(math.prod(F.local_slice(w, s, mesh).shape) for w, s in
                zip(tree_leaves(params), tree_leaves(PT.param_specs(params, cfg, mesh))))
    whole = sum(w.numel() for w in tree_leaves(params))
    got = {name: dict(kv.split("=") for kv in rows[name].split()[:4])
           for name in list(rows)[:2]}
    assert got["grad_wire_fp32_2pod_step"] == {
        "wire_bytes": str(4 * local), "carrier": f"f32:{4 * local}",
        "payload_bytes": str(4 * local), "not_ported": "ROADMAP_A6"}
    assert got["grad_wire_compressed_2pod_step"] == {
        "wire_bytes": str(2 * local), "carrier": f"bf16:{2 * local}",
        "payload_bytes": str(2 * whole), "not_ported": "ROADMAP_A6"}
    ratio = float(rows["grad_wire_pod_bytes_ratio"].split("x")[0])
    assert ratio >= 1.9 and ratio == pytest.approx(2.0)
    assert runner.SECTIONS[[n for n, _ in runner.SECTIONS].index("grad_wire")][1] == \
        "bench_grad_wire"
