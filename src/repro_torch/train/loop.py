"""Fault-tolerant training loop (port of ``repro.train.loop``).

Runs the train step to ``total_steps`` over a step-keyed batch stream,
with

* resume from the latest checkpoint on startup (``ckpt_dir``), the batch
  stream requested at the restored step;
* periodic atomic checkpoints, committed on a background thread
  (``async_saves``); every exit path drains the writer;
* SIGTERM preemption: at the next step boundary, force-save, drain and
  return ``preempted=True``;
* a bounded retry of the step's gradient phase (``fault_hook(step)``
  lets tests inject failures);
* a loss-spike monitor (``spike_factor``) that rolls the run back to the
  last good checkpoint and widens the checkpoint cadence, instead of
  checkpointing over it with poisoned state;
* straggler telemetry: a per-step wall-time EWMA; steps slower than
  ``straggler_factor ×`` it are counted and logged, and the checkpoint
  cadence tightens while they persist.

Each step's metrics are read back to the host, which ends the step on
the device, so the measured step time is the device's too.

**The retry differs from the reference's.** The reference's step is a
pure function, so it retries the whole step on the state it started
from. The port's optimizers update the state in place, and copying the
state every step would cost as much memory again (24.7 GB at full width).
So the step comes in two phases (``train_step.phases``, see
:func:`repro_torch.train.step.make_train_step`): the gradient phase reads
the state without touching it and ends in a sync, and the update phase
writes the state. A failure of the gradient phase is retried on the
untouched state and the same batch; once retries are exhausted the
pre-step state is checkpointed and the error raised, as in the
reference. A failure once the update has begun leaves the in-memory state
torn: it is neither retried nor checkpointed, the loop raises, and the
last committed checkpoint is the resume point. A step function without
``phases`` is taken as pure (it must not modify the state it is given):
the whole call is retried, as in the reference.

**Multi-process** (``torch.distributed``, one process per rank, see
:mod:`repro_torch.dist.multihost`): every process runs the loop in lock
step. Checkpoint snapshots are collective (FSDP and tensor-parallel
shards and the wire's residual rows are gathered into full leaves) and
only process 0 writes, whatever the transport; a restore gives each rank
its part of every full leaf, so a checkpoint resumes under another mesh
(FSDP ↔ data-parallel ↔ data × model ↔ one process); all processes barrier around
restore, and the restore step, at startup and on a spike rollback, is
process 0's LATEST after its commits, broadcast (only process 0 has
queued commits that move LATEST); at the end every process waits for
process 0's last commit, so the final checkpoint is on disk when the loop
returns on any rank. The SIGTERM flag is agreed every
``preempt_poll_every`` steps (any rank's signal stops them all at the
same step). A gradient phase that exhausts its retries raises without
the crash save, whose snapshot its peers would never join: the last
committed checkpoint is the restart point. The checkpoint cadence adapts
to stragglers only in a single process (it must stay the same on every
process). The loss is the mean over the ranks, so a spike rollback is
decided alike on every rank.

**Gradient-wire residuals** (``TrainState.wire_residuals``) restore row
by row (each rank its row of the stored ``(n, *shape)`` stack) and are
zero-initialized where the wire changed since the checkpoint: no
residuals stored, another replica count, another wire format (the
``wire_format`` stamped into the manifest); a run with no residuals
drops stored ones unread.
"""
from __future__ import annotations

import dataclasses
import math
import signal
import time
from typing import Callable, Iterator, Union

import torch

from repro_torch.dist import fsdp as F
from repro_torch.dist import multihost as MH
from repro_torch.train.checkpoint import CheckpointManager, flatten, latest_step, manifest
from repro_torch.train.train_state import TrainState
from repro_torch.tree import tree_leaves

__all__ = ["TrainLoopConfig", "run_training"]

# ``batches``: either a plain iterator, or a callable mapping the start
# step to an iterator — the loop calls it after restore (and again after
# a rollback) so the stream begins at the batch the run actually needs.
Batches = Union[Iterator, Callable[[int], Iterator]]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    keep_n: int = 3
    max_retries_per_step: int = 2
    straggler_factor: float = 3.0
    log_every: int = 10
    seed: int = 0
    # most-recent metrics rows kept in host memory (the returned
    # ``history``); None keeps everything
    history_cap: int | None = 10_000
    # serialize and commit checkpoints on a background thread; the step
    # pays only the snapshot. At most max_pending_saves snapshots queue
    # (a save blocks beyond that)
    async_saves: bool = True
    max_pending_saves: int = 2
    # loss-spike monitor: after ``spike_patience`` consecutive steps with
    # a non-finite loss or loss > ``spike_factor ×`` its EWMA, roll back
    # to the last good checkpoint and multiply the checkpoint cadence by
    # ``rollback_widen``. None disables. Requires ckpt_dir
    spike_factor: float | None = None
    spike_patience: int = 2
    max_rollbacks: int = 2
    rollback_widen: int = 2
    # multi-process: the SIGTERM agreement is a collective, so it is polled
    # every this many steps (a single process reacts at the next step)
    preempt_poll_every: int = 10
    # identity of the gradient-wire numerics (CompressedWire.wire_format):
    # stamped into checkpoint manifests and compared on restore, where a
    # resume under another format zero-inits the error-feedback residuals.
    # None (stateless transports) disables both
    wire_format: str | None = None


def _phases(train_step: Callable) -> tuple[Callable, Callable]:
    """(gradient phase, update phase) of a step; a step without phases is
    one pure call, retried whole."""
    phases = getattr(train_step, "phases", None)
    if phases is not None:
        return phases
    return train_step, lambda state, out, seed: out


def _agreed_restore_step(mgr: CheckpointManager) -> int | None:
    """The step every process restores (None: no checkpoint): process 0's
    LATEST after draining its queued commits, broadcast."""
    mgr.drain()
    if not MH.active():
        return latest_step(mgr.directory)
    found = latest_step(mgr.directory) if MH.is_primary() else None
    step = MH.broadcast_int(-1 if found is None else found)
    return None if step < 0 else step


def _zero(tree) -> None:
    with torch.no_grad():
        for r in tree_leaves(tree):
            r.zero_()


def _restore(mgr: CheckpointManager, state: TrainState, log, *, step: int | None = None,
             wire_format: str | None = None, transport=None, specs=None):
    """Restore ``state`` in place from ``mgr``'s checkpoint at ``step``
    (LATEST when None), tolerant of gradient-wire residual drift in every
    direction a restart can change the wire (the reference's four cases,
    with its log lines). Stored residuals are recognized by their layout:
    one ``(replicas, *param shape)`` leaf per parameter after the rest of
    the state (the reference's legacy 3-field state has the bare layout);
    a checkpoint of neither layout falls through to ``restore``'s own
    validation error. ``specs`` (the state's spec tree, with the manager's
    mesh) give this rank its part of every stored leaf, its row of the
    residual stacks among them; without them (one process) the stored
    leaves are this state's whole."""
    residuals = state.wire_residuals
    params = [tuple(p.shape) for p in tree_leaves(state.params)]
    flat = pflat = None
    if specs is not None:       # the stored leaves are full: compare full shapes
        flat, pflat = F.flat_specs(specs), F.flat_specs(specs.params)
        params = [F.full_shape(p, s, mgr.mesh) for p, s in zip(params, pflat)]
    man = manifest(mgr.directory, step=step)
    n_ckpt, shapes = man["n_leaves"], man["shapes"]
    n_state = len(flatten(state))

    def stored_replicas(start: int) -> int | None:
        """The replica count of a residual layout stored from leaf
        ``start`` on; None if the leaves there are not one."""
        tail = shapes[start:]
        if len(tail) != len(params) or not tail:
            return None
        ok = all(len(t) == len(p) + 1 and t[1:] == list(p) and t[0] == tail[0][0]
                 for t, p in zip(tail, params))
        return tail[0][0] if ok else None

    if residuals is not None:
        n_bare = n_state - len(params)
        if n_ckpt == n_bare:
            restored, at = mgr.restore_latest(state._replace(wire_residuals=None), step=step,
                                              specs=None if flat is None else flat[:n_bare])
            _zero(residuals)
            log("[loop] checkpoint has no wire_residuals; zero-initialized "
                "error-feedback buffers")
            return restored._replace(wire_residuals=residuals), at
        stored_n = stored_replicas(n_bare) if n_ckpt == n_state else None
        stored_fmt = (man.get("extra") or {}).get("wire_format")
        stale = None
        if stored_n is not None and stored_n != (transport.wire_replicas if transport else 1):
            stale = "wire replica count changed since checkpoint"
        elif stored_n is not None and None not in (stored_fmt, wire_format) \
                and stored_fmt != wire_format:
            stale = (f"gradient-wire format changed since checkpoint "
                     f"({stored_fmt} -> {wire_format})")
        if stale is not None:
            restored, at = mgr.restore_latest(state, step=step, skip=range(n_bare, n_state),
                                              specs=flat)
            _zero(residuals)
            log(f"[loop] {stale}; zero-initialized error-feedback buffers")
            return restored, at
    elif n_ckpt == n_state + len(params) and stored_replicas(n_state) is not None:
        # params stand in as structure-matching placeholders, left unread
        like = state._replace(wire_residuals=state.params)
        restored, at = mgr.restore_latest(like, step=step, skip=range(n_state, n_ckpt),
                                          specs=None if flat is None else flat + pflat)
        log("[loop] dropping checkpointed wire_residuals (stateless gradient transport)")
        return restored._replace(wire_residuals=None), at
    return mgr.restore_latest(state, step=step, specs=flat)


def run_training(state: TrainState, train_step: Callable, batches: Batches,
                 cfg: TrainLoopConfig, *, log: Callable[[str], None] = print,
                 fault_hook: Callable[[int], None] | None = None,
                 transport=None, specs=None) -> tuple[TrainState, dict]:
    """Run from ``state.step`` (or the latest checkpoint under
    ``cfg.ckpt_dir``) to ``cfg.total_steps``. Returns the final state and
    ``{"history", "stragglers", "preempted", "rollbacks"}``.

    ``batches`` may be a callable ``start_step -> iterator``: the loop
    calls it after the resume (and after a rollback), so the stream
    continues at the restored step. A plain iterator is accepted too; the
    caller then advances it past trained steps (the spike monitor needs
    the callable form: a rollback rewinds the stream). The stream is
    pulled once per step, before the retries: a retried step replays the
    same batch. ``fault_hook(step)`` runs at the start of each attempt of
    the gradient phase and may raise to simulate a failure.

    ``transport`` (the step's gradient transport) places the state: under
    multi-process its parameter specs (FSDP shards; none: replicated), its
    wire axis (the residual rows) and its mesh give the state's specs
    (:func:`repro_torch.dist.fsdp.train_state_specs`), by which snapshots
    gather full leaves and a restore keeps this rank's parts (the
    reference passes its state shardings instead). ``specs`` overrides
    them.
    """
    multiproc = MH.active()
    mesh = getattr(transport, "mesh", None)
    if specs is None and multiproc:
        specs = F.train_state_specs(state, getattr(transport, "pspecs", None), transport)
    mgr = CheckpointManager(cfg.ckpt_dir, every_steps=cfg.ckpt_every, keep_n=cfg.keep_n,
                            async_saves=cfg.async_saves, max_pending=cfg.max_pending_saves,
                            extra=({"wire_format": cfg.wire_format}
                                   if cfg.wire_format else None),
                            specs=None if specs is None else F.flat_specs(specs),
                            mesh=mesh) if cfg.ckpt_dir else None
    batches_fn = batches if callable(batches) else None
    if cfg.spike_factor is not None:
        if mgr is None:
            raise ValueError("spike_factor requires ckpt_dir "
                             "(rollback needs a checkpoint to return to)")
        if batches_fn is None:
            raise ValueError("spike_factor requires callable batches "
                             "(a rollback must rewind the data stream)")
    if multiproc:
        # every process must agree on whether a checkpoint exists before
        # any of them restores
        MH.barrier("repro:loop:start")
    if mgr:
        at_step = _agreed_restore_step(mgr)
        if at_step is not None:
            state, at = _restore(mgr, state, log, step=at_step, wire_format=cfg.wire_format,
                                 transport=transport, specs=specs)
            log(f"[loop] resumed from checkpoint at step {at}")
            MH.barrier("repro:loop:restored")
    gradients, update = _phases(train_step)

    stop = {"preempted": False}

    def _sigterm(sig, frame):
        stop["preempted"] = True
    old = None
    try:
        old = signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass      # not on the main thread

    ewma = None
    stragglers = 0
    history: list[dict] = []
    suspect: list[dict] = []     # rows of steps under spike suspicion

    def _record(rows):
        history.extend(rows)
        if cfg.history_cap is not None and len(history) > cfg.history_cap:
            del history[:len(history) - cfg.history_cap]

    def _save(at: int, *, force: bool = False):
        # at most one commit of a step's state (a cadence save and the
        # preemption save can name the same step)
        if saved_at[0] != at and mgr.maybe_save(at, state, force=force) is not None:
            saved_at[0] = at

    saved_at = [None]
    step = int(state.step)
    stream = batches_fn(step) if batches_fn else batches
    warm_until = step + 2     # the first steps carry warm-up; keep them out of the EWMA
    loss_ewma = None
    spike_run = 0
    rollbacks = 0
    try:
        while step < cfg.total_steps:
            batch = next(stream)
            t0 = time.perf_counter()
            attempt = 0
            while True:
                try:
                    if fault_hook is not None:
                        fault_hook(step)
                    out = gradients(state, batch, cfg.seed)
                    break
                except Exception as e:          # noqa: BLE001 — retry wall
                    attempt += 1
                    if attempt > cfg.max_retries_per_step:
                        if mgr and not multiproc:
                            # the gradient phase never touches the state:
                            # this is the state the step started from
                            _save(step, force=True)
                            log(f"[loop] step {step} failed {attempt}×; "
                                f"checkpointed for external restart: {e}")
                        elif multiproc:
                            # the crash save's snapshot is collective and the
                            # peers never reach it: raise, and restart from the
                            # last committed checkpoint
                            log(f"[loop] step {step} failed {attempt}×; raising for "
                                f"a restart from the last committed checkpoint: {e}")
                        raise
                    log(f"[loop] step {step} retry {attempt} after {type(e).__name__}")
            try:
                state, metrics = update(state, out, cfg.seed)
                row = {k: float(v) for k, v in metrics.items()}    # syncs the device
            except Exception as e:
                log(f"[loop] step {step} failed in the update phase; the state is torn, "
                    f"so it is neither retried nor checkpointed: resume from the last "
                    f"committed checkpoint: {e}")
                raise
            del out
            dt = time.perf_counter() - t0

            if cfg.spike_factor is not None:
                loss = row["loss"]
                spiked = not math.isfinite(loss) or (
                    loss_ewma is not None and loss > cfg.spike_factor * loss_ewma)
                if spiked:
                    spike_run += 1
                else:
                    spike_run = 0
                    loss_ewma = loss if loss_ewma is None else 0.9 * loss_ewma + 0.1 * loss
                if spike_run >= cfg.spike_patience:
                    # every process reaches this at the same step (the loss
                    # is the mean over the ranks); the step is still agreed,
                    # so a pending commit cannot land between two reads
                    at_step = _agreed_restore_step(mgr)
                    if at_step is None:
                        raise RuntimeError(f"loss diverged at step {step} (loss {loss:g}) "
                                           f"with no checkpoint to roll back to")
                    if rollbacks >= cfg.max_rollbacks:
                        # not checkpointed: LATEST keeps naming the last good state
                        raise RuntimeError(f"loss diverged at step {step} after "
                                           f"{rollbacks} rollbacks; giving up")
                    state, at = _restore(mgr, state, log, step=at_step,
                                         wire_format=cfg.wire_format, transport=transport,
                                         specs=specs)
                    MH.barrier("repro:loop:rolled-back")
                    saved_at[0] = None
                    rollbacks += 1
                    mgr.every_steps = cfg.ckpt_every * cfg.rollback_widen ** rollbacks
                    log(f"[loop] loss spike at step {step} (loss {loss:.4g}, ewma "
                        f"{loss_ewma if loss_ewma is None else round(loss_ewma, 4)}); "
                        f"rolled back to step {at}; ckpt_every -> {mgr.every_steps}")
                    suspect.clear()     # rows of the discarded trajectory
                    step = at
                    warm_until = at + 2
                    loss_ewma, spike_run = None, 0
                    stream = batches_fn(at)
                    continue            # the spiked state is never checkpointed

            straggling = step >= warm_until and ewma is not None and \
                dt > cfg.straggler_factor * ewma
            if step >= warm_until and not straggling:
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if straggling:
                stragglers += 1
                log(f"[loop] straggler: step {step} took {dt:.2f}s (ewma {ewma:.2f}s)")
            if mgr and spike_run == 0:
                # a step under spike suspicion is never committed: the
                # rollback target must predate the first suspicious update
                base = cfg.ckpt_every * cfg.rollback_widen ** rollbacks
                if not multiproc:
                    # local straggler counts: the cadence of several
                    # processes must stay the same (snapshots are collective)
                    mgr.every_steps = max(base // (2 if stragglers > 3 else 1), 1)
                _save(step + 1)
            if spike_run > 0:
                suspect.append(row)     # dropped if the run rolls back
            else:
                _record(suspect + [row])    # suspicion cleared: those updates stay
                suspect.clear()
            if step % cfg.log_every == 0:
                log(f"[loop] step {step} loss {row['loss']:.4f} ({dt * 1e3:.0f} ms)")
            # a collective under multi-process, so on a fixed step schedule
            poll = not multiproc or step % max(cfg.preempt_poll_every, 1) == 0
            if poll and MH.agree_any(stop["preempted"]):
                stop["preempted"] = True
                if mgr:
                    _save(step + 1, force=True)
                log(f"[loop] preempted at step {step}; checkpointed and exiting")
                break
            step += 1
    except BaseException:
        if mgr:
            try:
                mgr.drain()     # the crash checkpoint must reach the disk
            except Exception as e2:  # noqa: BLE001 — the original error wins
                log(f"[loop] checkpoint drain failed during unwind: {e2}")
        raise
    finally:
        if old is not None:
            signal.signal(signal.SIGTERM, old)
    # a run that ends under unresolved suspicion kept those updates
    _record(suspect)
    if mgr:
        mgr.drain()             # preemption and final saves committed before return
        if multiproc:
            # only process 0 commits: the others wait for its commits, so a
            # checkpoint is on disk when run_training returns on any rank
            MH.barrier("repro:loop:drained")
    return state, {"history": history, "stragglers": stragglers,
                   "preempted": stop["preempted"], "rollbacks": rollbacks}
