"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/<name>-<hash>.so``
at the repository root — the hash covers the source, the shared headers
``csrc/*.cuh`` and the flags, so an edited source is rebuilt — and loaded
once per process. Each kernel has its own lock, so ``load_all`` runs one
``nvcc`` per source at once. Building needs the CUDA toolkit; nothing
here runs when a kernel module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["BuildInfo", "load", "load_all", "builds"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -Xptxas -v reports registers, shared memory and spills per kernel
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float         # nvcc wall time; 0.0 when the library was cached
    log: str               # nvcc/ptxas output


_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
builds: dict[str, BuildInfo] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                           "the CUDA kernels need the CUDA toolkit to build")
    return str(path)


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, built if missing."""
    with _guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.read_bytes())
        so = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
        seconds, log = 0.0, ""
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        builds[name] = BuildInfo(so, seconds, log)
        _libs[name] = lib
        return lib


def load_all(names) -> dict[str, ctypes.CDLL]:
    """Build (one ``nvcc`` per source, all at once) and load ``names``."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(load, names)))
