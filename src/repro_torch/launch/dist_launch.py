"""Spawn an N-process ``torch.distributed`` run on one machine (the port's
counterpart of the reference's ``tools/dist_launch.py``).

    PYTHONPATH=src python -m repro_torch.launch.dist_launch -n 2 -- \\
        python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --device cpu --data-parallel 2 --grad-wire bf16 --steps 6

One child per rank, each given the ``REPRO_COORDINATOR`` /
``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` triple over a free
loopback port (consumed by :func:`repro_torch.dist.multihost.initialize`)
and ``src`` on its ``PYTHONPATH``. A SIGTERM to the launcher is forwarded
to every child. Once a child fails the others are killed (a dead peer
leaves the survivors in a collective that can only time out), as they are
at the deadline. The exit code is the worst child's: a child ended by a
signal counts as 128 + the signal.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["free_port", "launch", "wait", "terminate", "worst", "main"]

SRC = str(Path(__file__).resolve().parents[2])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: list[str], nprocs: int, *, env: dict | None = None,
           log_dir: str | Path | None = None,
           coordinator: str | None = None) -> list[subprocess.Popen]:
    """Start ``nprocs`` copies of ``argv``; returns their Popen handles.
    ``log_dir`` sends rank i's output to ``rank<i>.log`` (otherwise the
    children share this process's streams)."""
    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    base = dict(os.environ if env is None else env)
    base["REPRO_COORDINATOR"] = coordinator
    base["REPRO_NUM_PROCESSES"] = str(nprocs)
    pypath = base.get("PYTHONPATH", "")
    if SRC not in pypath.split(os.pathsep):
        base["PYTHONPATH"] = SRC + (os.pathsep + pypath if pypath else "")
    if log_dir is not None:
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i in range(nprocs):
        env_i = dict(base, REPRO_PROCESS_ID=str(i))
        if log_dir is None:
            procs.append(subprocess.Popen(argv, env=env_i))
            continue
        with open(log_dir / f"rank{i}.log", "wb") as out:
            procs.append(subprocess.Popen(argv, env=env_i, stdout=out,
                                          stderr=subprocess.STDOUT))
    return procs


def terminate(procs: list[subprocess.Popen], sig=signal.SIGTERM) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(sig)


def wait(procs: list[subprocess.Popen], timeout: float = 600.0) -> list[int]:
    """Wait for every child; returns their exit codes. Once any child fails,
    or at the deadline, the rest are killed."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        failed = any(c not in (None, 0) for c in codes)
        if all(c is not None for c in codes):
            return codes
        if failed or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            return [p.wait() for p in procs]
        time.sleep(0.1)


def worst(codes: list[int]) -> int:
    """The worst exit code, a death by signal s counted as 128 + s."""
    return max((128 - c if c < 0 else c) for c in codes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", "--nprocs", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before the remaining children are killed")
    ap.add_argument("--log-dir", default=None,
                    help="write rank<i>.log files here instead of interleaving")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="the command to run (after --)")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no command given (append: -- python -m repro_torch.launch.train ...)")
    procs = launch(cmd, args.nprocs, log_dir=args.log_dir)
    old = signal.signal(signal.SIGTERM, lambda *_: terminate(procs))
    try:
        codes = wait(procs, timeout=args.timeout)
    finally:
        signal.signal(signal.SIGTERM, old)
        terminate(procs, signal.SIGKILL)
    for i, c in enumerate(codes):
        if c != 0:
            print(f"[dist_launch] rank {i} exited {c}", file=sys.stderr)
    return worst(codes)


if __name__ == "__main__":
    sys.exit(main())
