"""Fault-tolerant checkpointing: atomic, async, keep-N (port of
``repro.train.checkpoint``).

Layout (one directory per step), the reference's own, so each package
restores the other's checkpoints::

    <dir>/step_000000123/
        manifest.json      # treedef, shapes, dtypes, step, wall time
        arrays.npz         # flattened leaves, key a{i} = leaf i
    <dir>/LATEST           # text file: "step_000000123" (atomic rename commit)

Leaves are numbered in the reference's flatten order: dict keys sorted,
NamedTuple fields in order, ``None`` contributing no leaf; the
``TrainState`` step (a Python int here) is leaf ``a0``, an int32 scalar.
bf16 leaves are stored as their raw bits, ``uint16``, with the dtype tag
``bfloat16`` in the manifest (npz has no bf16).

* **Atomicity** — writes go to ``<dir>/tmp.<step>.<nonce>`` and are
  committed by one ``os.replace`` of the directory name, then one of the
  LATEST pointer; a crash mid-write leaves only tmp dirs, removed once
  they are stale and no live writer of this process owns them.
* **Crash-safe discovery** — when LATEST is missing or dangles,
  :func:`latest_step` falls back to the newest ``step_*`` dir with a
  valid manifest and repairs the pointer.
* **Asynchrony** — :class:`CheckpointManager` with ``async_saves=True``
  takes the snapshot synchronously (each leaf copied to host memory the
  snapshot owns: the optimizers update the live tensors in place) and
  serializes and commits it on one background thread behind a bounded
  queue, so commits land in submission order. ``drain()`` blocks until
  the queue is empty and re-raises a background failure.
* **keep_n** — oldest-first GC that never removes the LATEST target.
* **Multi-process** (``torch.distributed``, one process per rank) —
  :func:`snapshot` is *collective* when given the state's specs
  (``specs=``, one per leaf: :func:`repro_torch.dist.fsdp.train_state_specs`,
  and the ``mesh``): every process calls it at the same step, every leaf a
  spec shards (FSDP and tensor-parallel shards, the gradient wire's
  residual rows) is gathered
  into the reference's full leaf on process 0
  (:func:`repro_torch.dist.fsdp.gather_full`; the residual rows into the
  reference's ``(n, *shape)`` stacks), and only process 0 copies the rest
  and touches the filesystem: it writes, repairs LATEST and prunes. All
  processes see the same paths. So a checkpoint holds full leaves whatever
  the mesh that wrote it.

:func:`restore` copies the stored values into the tensors of ``like`` in
place (casting to their dtype, on their device), so restoring a state
costs no second copy of it on the card; ``specs=``/``mesh=`` give a rank
its part of every full leaf (the counterpart of the reference's
``shardings=``: a checkpoint restores under any mesh), and ``skip=``
leaves stale leaves unread.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
import time
import uuid
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist import fsdp as F
from repro_torch.dist import multihost as MH

__all__ = ["save", "restore", "latest_step", "manifest", "snapshot", "flatten",
           "Snapshot", "AsyncCheckpointer", "CheckpointManager"]

PyTree = Any

# Tmp dirs from a *crashed* writer are garbage; tmp dirs from a *live*
# writer (async saves) are not. GC only removes tmp dirs that no writer in
# this process owns and that are older than this threshold.
TMP_STALE_SECS = 3600.0
_IN_FLIGHT: set[str] = set()
_IN_FLIGHT_LOCK = threading.Lock()


def _children(node) -> list | None:
    """The subtrees of an interior node in flatten order; None for a leaf."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(node)
    return None


def flatten(tree) -> list:
    """Leaves in the reference's flatten order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for k in kids for leaf in flatten(k)]


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(k) for k in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(k) for k in node)
        return next(it)

    return build(like)


def _treedef(node) -> str:
    """A structural rendering of the tree, for the manifest."""
    if node is None:
        return "None"
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(node[k])}" for k in sorted(node)) + "}"
    if isinstance(node, (tuple, list)):
        inner = ", ".join(_treedef(k) for k in node)
        if hasattr(node, "_fields"):
            return f"{type(node).__name__}({inner})"
        return f"[{inner}]" if isinstance(node, list) else f"({inner})"
    return "*"


def _leaf_to_host(x) -> tuple[np.ndarray, str]:
    """An owned host copy of a leaf and its dtype tag."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        bf16 = t.dtype == torch.bfloat16
        if bf16:
            t = t.view(torch.int16)
        # .cpu() of a device tensor copies; a CPU tensor shares its storage
        t = t.cpu() if t.device.type != "cpu" else t.clone()
        arr = t.numpy()
        if bf16:
            return arr.view(np.uint16), "bfloat16"
        return arr, str(arr.dtype)
    if isinstance(x, (int, np.integer)):
        arr = np.asarray(x, np.int32)      # the TrainState step: the reference's i32 scalar
        return arr, "int32"
    arr = np.array(x, copy=True)
    return arr, str(arr.dtype)


@dataclasses.dataclass
class Snapshot:
    """A host copy of a train-state tree, ready to serialize: produced
    synchronously by :func:`snapshot`, committed to disk by
    :func:`_commit` inline (``save``) or on the writer thread."""
    step: int
    arrays: dict[str, np.ndarray]
    manifest: dict


def snapshot(tree: PyTree, step: int, *, extra: dict | None = None,
             specs=None, mesh=None) -> Snapshot | None:
    """Copy every leaf to host memory the snapshot owns.

    ``specs`` (one per leaf, in flatten order) makes it collective: each
    leaf a spec shards is gathered into its full leaf on process 0 (every
    process must call), the others are process 0's own. Only process 0
    gets the snapshot; the others get None."""
    if specs is None:
        host = [_leaf_to_host(leaf) for leaf in flatten(tree)]
    else:
        host = []
        for leaf, spec in zip(flatten(tree), specs):
            if isinstance(leaf, torch.Tensor) and F.sharded_dims(spec):
                leaf = F.gather_full(leaf, spec, mesh)
            host.append(_leaf_to_host(leaf) if MH.is_primary() else None)
        if not MH.is_primary():
            return None
    man = {
        "step": int(step),
        "time": time.time(),
        "treedef": _treedef(tree),
        "n_leaves": len(host),
        "dtypes": [tag for _, tag in host],
        "shapes": [list(a.shape) for a, _ in host],
        "extra": extra or {},
    }
    return Snapshot(int(step), {f"a{i}": a for i, (a, _) in enumerate(host)}, man)


def _commit(directory: Path, snap: Snapshot, keep_n: int) -> Path:
    """Serialize and atomically commit a snapshot (tmp dir → rename →
    LATEST rename). Safe off-thread; registers its tmp dir so a
    concurrent ``_gc`` never deletes it mid-write."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"tmp.{snap.step}.{uuid.uuid4().hex[:8]}"
    with _IN_FLIGHT_LOCK:
        _IN_FLIGHT.add(str(tmp))
    try:
        tmp.mkdir()
        np.savez(tmp / "arrays.npz", **snap.arrays)
        (tmp / "manifest.json").write_text(json.dumps(snap.manifest))
        final = directory / f"step_{snap.step:09d}"
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        ptr = directory / f".latest.{uuid.uuid4().hex[:8]}"
        ptr.write_text(final.name)
        os.replace(ptr, directory / "LATEST")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        with _IN_FLIGHT_LOCK:
            _IN_FLIGHT.discard(str(tmp))
    _gc(directory, keep_n)
    return final


def save(directory: str | Path, step: int, tree: PyTree, *,
         keep_n: int = 3, extra: dict | None = None, specs=None, mesh=None) -> Path:
    """Synchronous snapshot and commit; collective with ``specs`` (only
    process 0 writes)."""
    snap = snapshot(tree, step, extra=extra, specs=specs, mesh=mesh)
    if snap is None:
        return Path(directory) / f"step_{step:09d}"
    return _commit(Path(directory), snap, keep_n)


def _gc(directory: Path, keep_n: int, *, stale_secs: float = TMP_STALE_SECS) -> None:
    keep = None
    latest = directory / "LATEST"
    if latest.exists():
        keep = latest.read_text().strip()
    steps = sorted(p for p in directory.glob("step_*") if p.is_dir())
    excess = steps[:-keep_n] if keep_n > 0 else []
    for p in excess:
        if p.name != keep:
            shutil.rmtree(p, ignore_errors=True)
    # tmp dirs: only strays of crashed writers — never one a live writer
    # of this process owns, never one recent enough to be in flight
    now = time.time()
    for pattern in ("tmp.*", ".latest.*"):
        for p in directory.glob(pattern):
            with _IN_FLIGHT_LOCK:
                if str(p) in _IN_FLIGHT:
                    continue
            try:
                age = now - p.stat().st_mtime
            except OSError:
                continue
            if age < stale_secs:
                continue
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
            else:
                try:
                    p.unlink()
                except OSError:
                    pass


def manifest(directory: str | Path, *, step: int | None = None) -> dict:
    """Parsed manifest of a checkpoint (leaf count, shapes, dtypes)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    return json.loads((directory / f"step_{step:09d}" / "manifest.json").read_text())


def _valid_step_dir(p: Path) -> bool:
    try:
        json.loads((p / "manifest.json").read_text())
        return True
    except (OSError, ValueError):
        return False


def latest_step(directory: str | Path, *, repair: bool = True) -> int | None:
    """Newest restorable step, honoring LATEST when it is sound; else the
    newest ``step_*`` dir whose manifest parses, and LATEST is repaired to
    name it (best effort)."""
    directory = Path(directory)
    latest = directory / "LATEST"
    if latest.exists():
        name = latest.read_text().strip()
        if _valid_step_dir(directory / name):
            return int(name.split("_")[-1])
    fallback = None
    for p in sorted(directory.glob("step_*"), reverse=True):
        if p.is_dir() and _valid_step_dir(p):
            fallback = p
            break
    if fallback is None:
        return None
    if repair and MH.is_primary():
        try:
            ptr = directory / f".latest.{uuid.uuid4().hex[:8]}"
            ptr.write_text(fallback.name)
            os.replace(ptr, latest)
        except OSError:
            pass      # read-only or racing repair: the fallback scan still works
    return int(fallback.name.split("_")[-1])


def _stored_tensor(arr: np.ndarray, tag: str) -> torch.Tensor:
    if tag == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(directory: str | Path, like: PyTree, *, step: int | None = None,
            skip=(), specs=None, mesh=None) -> tuple[PyTree, int]:
    """Restore into the structure of ``like``: each tensor leaf of ``like``
    receives its stored value in place (cast to its dtype, on its device:
    a checkpoint of another policy restores into this one's formats), and
    a Python int leaf (the ``TrainState`` step) is replaced by the stored
    integer. Returns the tree and the step restored (LATEST's unless
    ``step`` is given).

    ``skip`` (leaf indices) leaves those stored leaves unread: ``like``'s
    leaf comes back as it is. ``specs`` (one per leaf, with ``mesh``) give
    each leaf this rank's part of the stored full leaf
    (:func:`repro_torch.dist.fsdp.local_slice`)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    src = directory / f"step_{step:09d}"
    man = json.loads((src / "manifest.json").read_text())
    leaves = flatten(like)
    if man["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {man['n_leaves']} leaves, expected {len(leaves)}")
    skip = frozenset(skip)
    out = []
    with np.load(src / "arrays.npz") as data:
        for i, ref in enumerate(leaves):
            if i in skip:
                out.append(ref)
                continue
            arr = data[f"a{i}"]
            if list(arr.shape) != man["shapes"][i]:
                raise ValueError(f"leaf {i}: stored shape {arr.shape} != manifest")
            if specs is not None and F.sharded_dims(specs[i]):
                arr = F.local_slice(arr, specs[i], mesh)
            if isinstance(ref, torch.Tensor):
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != model "
                                     f"{tuple(ref.shape)}")
                with torch.no_grad():
                    ref.copy_(_stored_tensor(arr, man["dtypes"][i]))
                out.append(ref)
            elif isinstance(ref, (int, np.integer)):
                if arr.shape != ():
                    raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} for a scalar")
                out.append(int(arr))
            else:
                raise TypeError(f"leaf {i}: cannot restore into {type(ref).__name__}")
    return _unflatten(like, out), step


class AsyncCheckpointer:
    """Single background writer: FIFO commits, bounded queue.

    ``submit`` blocks once ``max_pending`` snapshots are queued (bounded
    host memory). One worker consuming a FIFO queue commits in submission
    order. A failed background commit is re-raised on the next
    ``submit``/``drain``.
    """

    _CLOSE = object()

    def __init__(self, *, max_pending: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None
        self._lock = threading.Lock()

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._worker, name="repro-ckpt-writer", daemon=True)
                self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is self._CLOSE:
                    return
                directory, snap, keep_n = item
                try:
                    _commit(directory, snap, keep_n)
                except BaseException as e:  # noqa: BLE001 — surfaced at drain
                    self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async checkpoint commit failed") from err

    def submit(self, directory: Path, snap: Snapshot, keep_n: int) -> None:
        self._raise_pending()
        self._ensure_thread()
        self._q.put((Path(directory), snap, keep_n))

    def drain(self) -> None:
        """Block until every queued snapshot is committed; re-raise any
        background failure."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        self.drain()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None and t.is_alive():
            self._q.put(self._CLOSE)
            t.join(timeout=30)


class CheckpointManager:
    """Cadence and retention around save/restore, optionally async.

    ``async_saves=True`` moves serialization and commit to a background
    thread (:class:`AsyncCheckpointer`); ``maybe_save`` then pays only the
    snapshot. Callers that read checkpoints back (or exit) must
    ``drain()`` first — ``run_training`` does, on every exit path.
    """

    def __init__(self, directory: str | Path, *, every_steps: int = 100,
                 keep_n: int = 3, async_saves: bool = False,
                 max_pending: int = 2, extra: dict | None = None, specs=None,
                 mesh=None):
        self.directory = Path(directory)
        self.every_steps = every_steps
        self.keep_n = keep_n
        # run-level metadata stamped into every manifest (the gradient
        # wire's format, so a resume under another wire sees stale residuals)
        self.extra = dict(extra) if extra else {}
        # multi-process: the state's specs (one per leaf) and mesh, so that
        # snapshots gather sharded leaves and residual rows to process 0
        self.specs, self.mesh = specs, mesh
        self._async = AsyncCheckpointer(max_pending=max_pending) if async_saves else None

    def maybe_save(self, step: int, tree: PyTree, *, force: bool = False):
        """Save at the cadence (or when forced). Collective under
        multi-process: every process calls it at the same steps."""
        if not (force or (self.every_steps and step % self.every_steps == 0 and step > 0)):
            return None
        if self._async is None:
            return save(self.directory, step, tree, keep_n=self.keep_n, extra=self.extra,
                        specs=self.specs, mesh=self.mesh)
        snap = snapshot(tree, step, extra=self.extra, specs=self.specs, mesh=self.mesh)
        if snap is not None:
            self._async.submit(self.directory, snap, self.keep_n)
        return self.directory / f"step_{step:09d}"

    def drain(self):
        if self._async is not None:
            self._async.drain()

    def close(self):
        if self._async is not None:
            self._async.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def restore_latest(self, like: PyTree, step: int | None = None, *, skip=(),
                       specs=None):
        """Restore the newest checkpoint — or, with ``step``, that one —
        after the queued commits (see :func:`restore`; ``specs`` with the
        manager's mesh)."""
        self.drain()
        return restore(self.directory, like, step=step, skip=skip, specs=specs, mesh=self.mesh)

    def has_checkpoint(self) -> bool:
        self.drain()
        return latest_step(self.directory) is not None
