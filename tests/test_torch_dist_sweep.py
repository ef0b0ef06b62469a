"""The runner's ``grad_wire_sweep`` section (its training rows) on the CPU.

* ``--smoke`` prints the reference's rows (the LM's fp32, bf12 and keep
  cells), each row's payload bytes, carrier and ratio equal to what the
  reference's sweep computes for the same wire, bf12's ratio ≥ 2.6, the
  losses finite and falling from the start (~6.7 at vocab 512).
* The full section's rows and its two assertions, with the training
  replaced by fixed losses: the ``_hlo`` rows name ROADMAP A6, and a keep
  cell outside ``TOL`` of fp32 fails the section.
* ``grad_wire`` (4 data × 2 model meshes: training on the model axis)
  fails loudly naming A11.
"""
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


def test_grad_wire_section_names_a10():
    with pytest.raises(NotImplementedError, match=r"grad_wire is not ported yet \(ROADMAP A11\)"):
        runner.run_section("grad_wire", device="cpu")
