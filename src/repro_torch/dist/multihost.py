"""Multi-process lifecycle on ``torch.distributed`` (port of
``repro.dist.multihost``).

One process per rank. The launcher calls :func:`initialize` before it
builds the model; :mod:`repro_torch.launch.dist_launch` spawns N such
processes on one machine, passing the reference's coordination triple
through environment variables:

======================  =======================================
``REPRO_COORDINATOR``   ``host:port`` of process 0's TCP store
``REPRO_NUM_PROCESSES`` total process count
``REPRO_PROCESS_ID``    this process's rank
======================  =======================================

Everything here is a no-op in a single-process run, so the same entry
points work unchanged on one card and across several.

The process group's backend follows the device: NCCL for CUDA, gloo for
the CPU. A caller may name ``backend="gloo"`` for CUDA tensors (the
launcher's ``--dist-backend gloo``): that is the rehearsal of several
ranks on one card, which NCCL refuses; the collectives then run on the
host (see :func:`group_device`). Nothing switches backend or device on its
own. Every group gets a timeout, so a collective that a peer never joins
raises instead of hanging; a collective that fails raises.

Process-0 semantics elsewhere (checkpoint commits, LATEST repair,
logging) key off :func:`process_index`; this module owns initialization,
barriers and the small host agreements the training loop makes.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_PROCESS_ID", "initialize",
           "shutdown", "active", "process_index", "process_count", "is_primary",
           "barrier", "group_device", "agree_any", "broadcast_int"]

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device="cuda",
               backend: str | None = None, timeout_secs: float = 120.0) -> bool:
    """Join the process group, if one is configured.

    Arguments default to the ``REPRO_*`` environment variables; with
    neither given (or ``num_processes <= 1``) this is a no-op returning
    False: the single-process path. A partial triple (coordinator and
    process count but no rank) raises ``ValueError`` naming the missing
    flag. On CUDA each rank takes card ``rank % device_count``.
    ``timeout_secs`` bounds every collective of the group.
    """
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID):
        process_id = int(os.environ[ENV_PROCESS_ID])
    if not coordinator or not num_processes or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError(
            "multihost.initialize: coordinator and num_processes are set "
            "but process_id is not — pass process_id= (--process-id) or "
            f"set {ENV_PROCESS_ID}")
    device = torch.device(device)
    backend = backend or default_backend(device)
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_secs))
    return True


def shutdown() -> None:
    """Leave the process group (no-op when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def active() -> bool:
    """True when this process is part of a multi-process run."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Process-0 semantics: the one process that writes checkpoints,
    repairs LATEST, and logs."""
    return process_index() == 0


def group_device(group=None) -> torch.device:
    """Where a collective of ``group`` (default: the world) runs: the
    current card for NCCL, the host for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(tag: str) -> None:
    """Block until every process reaches this point (no-op when
    single-process). ``tag`` names the point in errors."""
    if not active():
        return
    try:
        dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r} failed: {e}") from e


def agree_any(flag: bool) -> bool:
    """True on every process if it is True on any (a MAX all-reduce)."""
    if not active():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=group_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_int(value: int) -> int:
    """Process 0's ``value``, on every process."""
    if not active():
        return value
    t = torch.tensor([value], dtype=torch.int64, device=group_device())
    dist.broadcast(t, src=0)
    return int(t.item())
