"""Training loop (port of ``repro.train.loop``: ``TrainLoopConfig`` and
``run_training``, single process).

Runs the train step to ``total_steps`` over a step-keyed batch stream,
with straggler telemetry (a per-step wall-time EWMA; steps slower than
``straggler_factor ×`` it are counted and logged) and a bounded metrics
history. Each step's loss is read back to the host, which ends the step
on the device, so the measured step time is the device's too.

Checkpointing, resume, the loss-spike rollback, SIGTERM handling and
multi-host runs belong to the checkpointed-training slice (ROADMAP A);
asking for them raises. The reference's retry of a failed step is left
out as well: the port's optimizers update the state in place, so a step
that fails part-way cannot be replayed from the state it started from.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Union

from repro_torch.train.train_state import TrainState

__all__ = ["TrainLoopConfig", "run_training"]

# ``batches``: either a plain iterator, or a callable mapping the start
# step to an iterator, called with the state's step
Batches = Union[Iterator, Callable[[int], Iterator]]

_LATER = "is ported with the checkpointed-training slice (ROADMAP A)"


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    straggler_factor: float = 3.0
    log_every: int = 10
    seed: int = 0
    # most-recent metrics rows kept in host memory (the returned
    # ``history``); None keeps everything
    history_cap: int | None = 10_000
    ckpt_dir: str | None = None
    spike_factor: float | None = None


def run_training(state: TrainState, train_step: Callable, batches: Batches,
                 cfg: TrainLoopConfig, *, log: Callable[[str], None] = print
                 ) -> tuple[TrainState, dict]:
    """Run from ``state.step`` to ``cfg.total_steps``. Returns the final
    state and ``{"history", "stragglers", "preempted", "rollbacks"}``."""
    if cfg.ckpt_dir is not None:
        raise ValueError(f"checkpointing (ckpt_dir) {_LATER}")
    if cfg.spike_factor is not None:
        raise ValueError(f"the loss-spike monitor (spike_factor) {_LATER}")
    step = int(state.step)
    stream = batches(step) if callable(batches) else batches
    warm_until = step + 2        # the first steps carry warm-up; keep them out of the EWMA
    ewma = None
    stragglers = 0
    history: list[dict] = []
    while step < cfg.total_steps:
        batch = next(stream)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, cfg.seed)
        row = {k: float(v) for k, v in metrics.items()}    # syncs the device
        dt = time.perf_counter() - t0
        straggling = step >= warm_until and ewma is not None and dt > cfg.straggler_factor * ewma
        if step >= warm_until and not straggling:
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if straggling:
            stragglers += 1
            log(f"[loop] straggler: step {step} took {dt:.2f}s (ewma {ewma:.2f}s)")
        history.append(row)
        if cfg.history_cap is not None and len(history) > cfg.history_cap:
            del history[:len(history) - cfg.history_cap]
        if step % cfg.log_every == 0:
            log(f"[loop] step {step} loss {row['loss']:.4f} ({dt * 1e3:.0f} ms)")
        step += 1
    return state, {"history": history, "stragglers": stragglers,
                   "preempted": False, "rollbacks": 0}
