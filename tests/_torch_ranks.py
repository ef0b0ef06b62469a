"""Launch N ranks of a test worker through ``repro_torch.launch.dist_launch``
and, when they fail, report each rank's own log (the launcher's combined
output interleaves the ranks and cuts the tails)."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def rank_env(**extra) -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""),
                **extra)


def config_overrides(spec: str) -> tuple[str, dict]:
    """``arch`` or ``arch:field=N:...`` → (arch, the integer config fields
    to replace), e.g. ``recurrentgemma-2b:n_heads=5``."""
    arch, *fields = spec.split(":")
    return arch, {k: int(v) for k, v in (f.split("=") for f in fields)}


def log_tails(log_dir: Path, n: int, chars: int = 3000) -> str:
    """The last ``chars`` characters of every rank's log."""
    out = []
    for r in range(n):
        path = Path(log_dir) / f"rank{r}.log"
        text = path.read_text(errors="replace") if path.exists() else "(no log)"
        out.append(f"--- rank {r} ({path}) ---\n{text[-chars:]}")
    return "\n".join(out)


def start_ranks(worker: str, args: list[str], n: int, log_dir: Path, timeout: float,
                env: dict | None = None) -> tuple:
    """Start ``python worker *args`` on ``n`` ranks; :func:`wait_ranks`
    ends it."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dist_launch", "-n", str(n), "--timeout",
           str(timeout - 10), "--log-dir", str(log_dir), "--", sys.executable, worker, *args]
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                            env=env or rank_env(), cwd=ROOT)
    return proc, n, log_dir, timeout


def wait_ranks(launch: tuple) -> None:
    """Wait for a :func:`start_ranks` launch; raise AssertionError with
    every rank's log tail unless all ranks exit 0."""
    proc, n, log_dir, timeout = launch
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, (f"dist_launch exited {proc.returncode}\n{err[-1000:]}\n"
                                  + log_tails(log_dir, n))


def run_ranks(worker: str, args: list[str], n: int, log_dir: Path, timeout: float,
              env: dict | None = None) -> None:
    """Run ``python worker *args`` on ``n`` ranks; raise AssertionError with
    every rank's log tail unless all exit 0."""
    wait_ranks(start_ranks(worker, args, n, log_dir, timeout, env))
