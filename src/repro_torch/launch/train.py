"""Training launcher (port of ``repro.launch.train``, single device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --device cpu --steps 30
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --policy bf16_sr_kahan --fused-update --batch 2 --seq 2048 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --device cpu --steps 30 --ckpt-dir /tmp/run1 --ckpt-every 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \\
        --reduced --device cpu --steps 30

``--arch`` takes every decoder-only architecture of the registry (dense,
MoE, Mamba, the RG-LRU hybrid, and qwen2-vl, which trains on the token
stream as the reference's launcher trains it: standard RoPE). The stream
has no audio, so whisper-base is refused.

Runs on CUDA unless ``--device cpu``; without a card it raises. AdamW with
β₂ = 0.997 (snapped to 0.99609375 in bf16) and weight decay 0.01 under a
linear-warmup cosine schedule; ``--fused-update`` runs the update through
the hand-written fused AdamW kernel, otherwise the non-fused optimizer
(whose SR writes under ``bf16_sr*`` go through the ``sr_cast`` kernel on
the card). ``--ckpt-dir`` checkpoints every ``--ckpt-every`` steps (on a
background writer unless ``--sync-ckpt``) and resumes from the latest
checkpoint there, printing ``[loop] resumed from checkpoint at step N``;
SIGTERM checkpoints at the next step boundary and exits;
``--spike-factor`` rolls a loss spike back to the last checkpoint. Flags
of later slices — meshes, FSDP, pods, compressed gradient wires,
multi-host — are accepted and refused with the slice that ports them
(ROADMAP A5). Ends with ``[train] done at step N; final loss …``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable

from repro_torch import resolve_device
from repro_torch.core.policy import PrecisionPolicy, get_policy
from repro_torch.data.synthetic import lm_batches
from repro_torch.models import registry as R
from repro_torch.optim import adamw, fused_adamw_optimizer, linear_warmup_cosine
from repro_torch.optim.base import Optimizer
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import TrainState, make_train_state

__all__ = ["parse_args", "make_optimizer", "build", "TrainRun", "loop_config", "train",
           "main"]

_DIST = "the dist slice (ROADMAP A5)"


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-friendly)")
    ap.add_argument("--policy", default="bf16_sr")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per step over one working copy "
                         "(f32 gradient sum, one update on the mean)")
    ap.add_argument("--fused-update", action="store_true",
                    help="run the update through the fused AdamW CUDA kernel "
                         "(bf16 policies only)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: resume from its latest checkpoint, "
                         "save every --ckpt-every steps and on SIGTERM")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--sync-ckpt", action="store_true",
                    help="commit checkpoints inline instead of on the background "
                         "writer thread")
    ap.add_argument("--spike-factor", type=float, default=None,
                    help="loss-spike monitor: roll back to the last good checkpoint "
                         "after --spike-patience consecutive steps with loss > "
                         "factor x EWMA (or non-finite)")
    ap.add_argument("--spike-patience", type=int, default=2)
    ap.add_argument("--max-rollbacks", type=int, default=2)
    ap.add_argument("--preempt-poll", type=int, default=10,
                    help="multi-host: poll the SIGTERM agreement every this many "
                         "steps (no effect in a single process)")
    # flags of later slices: accepted, refused in parse_args
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--fsdp-parallel", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--grad-wire", default="fp32",
                    choices=["fp32", "compressed", "bf16", "bf14", "bf12",
                             "bf10", "fp16", "e5m2", "e4m3"])
    ap.add_argument("--wire-keep-fp32", default=None)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    ap = _parser()
    args = ap.parse_args(argv)
    later = [
        ("mesh sizes above 1", args.data_parallel * args.model_parallel
         * args.fsdp_parallel > 1, _DIST),
        ("--fsdp", args.fsdp, _DIST),
        ("--pods", args.pods != 1, _DIST),
        (f"--grad-wire {args.grad_wire}", args.grad_wire != "fp32", _DIST),
        ("--wire-keep-fp32", args.wire_keep_fp32 is not None, _DIST),
        ("--coordinator/--num-processes/--process-id",
         any(a is not None for a in (args.coordinator, args.num_processes,
                                     args.process_id)), _DIST),
    ]
    for flag, given, slice_ in later:
        if given:
            raise ValueError(f"{flag} is ported with {slice_}")
    return args


def make_optimizer(args, policy: PrecisionPolicy) -> Optimizer:
    if args.fused_update:
        return fused_adamw_optimizer(policy, b2=0.997, weight_decay=0.01)
    return adamw(policy, b2=0.997, weight_decay=0.01)


@dataclasses.dataclass
class TrainRun:
    cfg: Any
    policy: PrecisionPolicy
    optimizer: Optimizer
    state: TrainState
    step_fn: Callable
    batches: Callable[[int], Any]


def build(args, *, optimizer: Optimizer | None = None, cfg=None) -> TrainRun:
    """Config (``--arch``, or ``cfg`` when given), random weights from
    ``--seed`` on the device, optimizer (``make_optimizer`` unless one is
    given), state, step and batch stream — everything ``train`` runs."""
    device = resolve_device(args.device)
    policy = get_policy(args.policy)
    if cfg is None:
        cfg = R.get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    if cfg.encdec:
        raise ValueError(f"{cfg.name}: the launcher trains on the token stream, and an "
                         "encoder-decoder takes an audio batch (src_embeds, tokens, labels)")
    params = R.init(cfg, args.seed, policy.param_dtype, device=device)
    opt = optimizer if optimizer is not None else make_optimizer(args, policy)
    lr_schedule = linear_warmup_cosine(args.lr, max(args.steps // 20, 1), args.steps)
    step_fn = make_train_step(cfg, policy, opt, lr_schedule, grad_accum=args.grad_accum,
                              attn_chunk=min(1024, args.seq))

    def batches(start_step):
        # step-keyed stream: a run starting at step k continues with batch k
        return lm_batches(cfg.vocab, args.batch, args.seq, seed=args.seed,
                          start_step=start_step, device=device)

    return TrainRun(cfg, policy, opt, make_train_state(params, opt), step_fn, batches)


def loop_config(args) -> TrainLoopConfig:
    """The loop's configuration from the launcher's flags."""
    return TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every, seed=args.seed,
                           async_saves=not args.sync_ckpt, spike_factor=args.spike_factor,
                           spike_patience=args.spike_patience,
                           max_rollbacks=args.max_rollbacks,
                           preempt_poll_every=args.preempt_poll)


def train(args, run: TrainRun, *, log: Callable[[str], None] = print, fault_hook=None):
    """Run ``run`` to ``--steps`` and print the closing line."""
    state, info = run_training(run.state, run.step_fn, run.batches, loop_config(args),
                               log=log, fault_hook=fault_hook)
    last = info["history"][-1] if info["history"] else {}
    log(f"[train] done at step {state.step}; final loss {last.get('loss', float('nan')):.4f}; "
        f"stragglers={info['stragglers']} preempted={info['preempted']} "
        f"rollbacks={info['rollbacks']}")
    return state, info


def main(argv=None):
    args = parse_args(argv)
    run = build(args)
    print(f"[train] {run.cfg.name} policy={run.policy.name} optimizer={run.optimizer.name} "
          f"batch={args.batch} seq={args.seq} steps={args.steps} device={args.device}")
    train(args, run)


if __name__ == "__main__":
    main()
