"""Training launcher (port of ``repro.launch.train``).

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
``--spike-factor`` rolls a loss spike back to the last checkpoint. Ends
with ``[train] done at step N; final loss …``, printed by process 0.

Data parallelism across processes: the same entry point runs once per
rank, joined by ``--coordinator/--num-processes/--process-id`` or the
``REPRO_*`` variables that :mod:`repro_torch.launch.dist_launch` sets::

    PYTHONPATH=src python -m repro_torch.launch.dist_launch -n 2 -- \\
        python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --device cpu --data-parallel 2 --grad-wire bf16 --steps 6 \\
        --ckpt-every 3 --ckpt-dir /tmp/dp

FSDP shards the parameters, the optimizer state and the wire's residual
rows over an ``fsdp`` axis (``--fsdp-parallel K``) or, with ``--fsdp``
alone, over ``data`` (ZeRO-3): each step gathers the bf16 working copy
once, reduce-scatters the gradients and updates the shards::

    PYTHONPATH=src python -m repro_torch.launch.dist_launch -n 2 -- \
        python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \
        --device cpu --fsdp-parallel 2 --fused-update --policy bf16_sr_kahan

A multi-process run with no topology flags is data-parallel over every
rank; otherwise ``--pods × --data-parallel × --fsdp-parallel`` must equal
the process count (``--pods 2 --data-parallel 2`` and ``--pods 2
--fsdp-parallel 2`` are the hierarchical compositions: the inner
reduction within each pod, the wire across pods). ``--grad-wire`` selects
the transport on the wire axis (``pod`` when ``--pods > 1``, else
``data``): ``fp32`` (with no pod axis, the f32 mean over ``data``), or an
SR-compressed wire with error-feedback residuals at ``compressed`` (=
bf16), ``bf16``, ``bf14``, ``bf12``, ``bf10``, ``fp16``, ``e5m2`` or
``e4m3``; ``--wire-keep-fp32`` keeps embeddings, norms, biases and small
leaves at fp32. A wire on the axis FSDP shards over is refused. In a
single process a compressed wire runs its local arithmetic (one replica,
no collective). The process group's backend follows the device (NCCL on
CUDA, gloo on the CPU); ``--dist-backend gloo`` runs several ranks on one
card, which NCCL refuses, with the collectives' payloads through host
memory.

Tensor parallelism: ``--model-parallel M`` adds the ``model`` axis
(innermost: a model group is M consecutive ranks), and ``--pods ×
--data-parallel × --model-parallel`` must equal the process count. Each
rank holds its Megatron shards of the dense families' kernels (the
reference's name rules, ``partition.param_specs``) and their optimizer
state, runs its forward and backward with the model group's collectives
(:mod:`repro_torch.dist.axes`), takes the loss on its vocab columns, and
the gradient wire and mean ride the data and pod axes only; the fused
update runs on each shard with its folded seed::

    PYTHONPATH=src python -m repro_torch.launch.dist_launch -n 4 -- \
        python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \
        --device cpu --data-parallel 2 --model-parallel 2 --grad-wire bf16

Every decoder-only family trains on a model axis (the MoE families with
tensor parallelism inside the experts, Mamba and RG-LRU on channel
shards), head counts and a vocabulary it does not divide included;
channel widths it does not divide are ROADMAP A12, FSDP beside it A13;
both raise. The launcher trains on the token stream, so whisper (an
audio batch) trains on the axis through ``make_train_step(mesh=)``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable

from repro_torch import resolve_device
from repro_torch.core.policy import PrecisionPolicy, get_policy
from repro_torch.data.synthetic import lm_batches
from repro_torch.dist import fsdp as F
from repro_torch.dist import multihost as MH
from repro_torch.dist import partition as PT
from repro_torch.dist import transport as TR
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.models import registry as R
from repro_torch.optim import adamw, fused_adamw_optimizer, linear_warmup_cosine
from repro_torch.optim.base import Optimizer
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import TrainState, make_train_state

__all__ = ["parse_args", "make_optimizer", "build", "TrainRun", "loop_config", "train",
           "main"]


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
                    help="multi-process: poll the (collective) SIGTERM agreement "
                         "every this many steps")
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="size of the model mesh axis (tensor parallelism of the dense "
                         "families)")
    ap.add_argument("--fsdp-parallel", type=int, default=1,
                    help="size of a dedicated fsdp mesh axis (implies --fsdp)")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard params and optimizer state (Kahan buffers and wire "
                         "residuals included) over the fsdp axis, else over data")
    ap.add_argument("--pods", type=int, default=1,
                    help="pod mesh axis size: data parallelism whose gradient mean "
                         "rides the --grad-wire")
    ap.add_argument("--grad-wire", default="fp32",
                    choices=["fp32", "compressed", "bf16", "bf14", "bf12",
                             "bf10", "fp16", "e5m2", "e4m3"],
                    help="gradient transport on the wire axis: fp32 mean, or an "
                         "SR-compressed wire with error feedback at the named format "
                         "('compressed' = bf16; e5m2/e4m3 clamped at max_finite)")
    ap.add_argument("--wire-keep-fp32", default=None,
                    help="per-leaf fp32 keep on a compressed wire: 'default' "
                         "(embeddings/norms/biases/scales and leaves < 2048 elements), "
                         "'none', or a comma list of name patterns with an optional "
                         "size threshold, e.g. '4096,embed,norm'")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0's store (default $REPRO_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="total process count (default $REPRO_NUM_PROCESSES)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank (default $REPRO_PROCESS_ID)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend; by default NCCL on CUDA, gloo on "
                         "the CPU (gloo on CUDA: several ranks on one card)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags; FSDP beside a model axis above 1 (ROADMAP
    A13) raises."""
    args = _parser().parse_args(argv)
    if args.model_parallel > 1 and (args.fsdp or args.fsdp_parallel > 1):
        raise ValueError(f"--model-parallel {args.model_parallel} with FSDP is "
                         f"{PT.FSDP_TP_ITEM}")
    return args


def make_optimizer(args, policy: PrecisionPolicy, mesh: Mesh | None = None,
                   pspecs=None) -> Optimizer:
    """AdamW, fused or not; on a mesh the fused update runs shard-local."""
    if args.fused_update:
        return fused_adamw_optimizer(policy, b2=0.997, weight_decay=0.01, mesh=mesh,
                                     pspecs=pspecs)
    return adamw(policy, b2=0.997, weight_decay=0.01)


@dataclasses.dataclass
class TrainRun:
    cfg: Any
    policy: PrecisionPolicy
    optimizer: Optimizer
    state: TrainState
    step_fn: Callable
    batches: Callable[[int], Any]
    transport: TR.GradientTransport
    mesh: Mesh | None = None


def _topology(args) -> dict | None:
    """The run's axis sizes by the reference's topology rule, or None for
    a single process given none."""
    dp, mp, fs, pods = args.data_parallel, args.model_parallel, args.fsdp_parallel, args.pods
    if MH.active() and dp * mp * fs * pods == 1:
        # multi-process with no explicit topology: data-parallel over every
        # rank (a one-process mesh would leave the collectives unformed)
        dp = MH.process_count()
    if dp * mp * fs * pods == 1:
        return None
    return dict(data=dp, model=mp, fsdp=fs, pods=pods)


def build(args, *, optimizer: Optimizer | None = None, cfg=None) -> TrainRun:
    """Config (``--arch``, or ``cfg`` when given), random weights from
    ``--seed`` on the device, mesh, optimizer (``make_optimizer`` unless
    one is given), transport, state, step and batch stream — everything
    ``train`` runs. Joins the process group first when one is configured
    (:func:`repro_torch.dist.multihost.initialize`)."""
    device = resolve_device(args.device)
    MH.initialize(args.coordinator, args.num_processes, args.process_id, device=device,
                  backend=args.dist_backend)
    policy = get_policy(args.policy)
    if cfg is None:
        cfg = R.get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    if cfg.encdec:
        raise ValueError(f"{cfg.name}: the launcher trains on the token stream, and an "
                         "encoder-decoder takes an audio batch (src_embeds, tokens, labels)")
    topo = _topology(args)
    if topo is not None:
        # what the model axis does not train (ROADMAP A12), before any process
        # group is built
        reason = PT.serve_refusal(cfg, Mesh((PT.DATA_AXIS, PT.MODEL_AXIS),
                                            (topo["data"], topo["model"])))
        if reason is not None:
            raise ValueError(reason)
    params = R.init(cfg, args.seed, policy.param_dtype, device=device)
    mesh = None if topo is None else make_local_mesh(**topo)
    wire_policy = (TR.WirePolicy.parse(args.wire_keep_fp32)
                   if args.wire_keep_fp32 is not None else None)
    placement = pspecs = None
    if mesh is not None:
        placement = PT.default_placement(mesh, fsdp=args.fsdp or args.fsdp_parallel > 1)
        pspecs = PT.param_specs(params, cfg, mesh, placement)
        # each rank keeps its shards (the whole of a replicated leaf); the
        # state is then built on them, before the first step
        params = F.shard_state(params, pspecs, mesh)
    opt = optimizer if optimizer is not None else make_optimizer(args, policy, mesh, pspecs)
    transport = TR.make_transport(mesh=mesh, placement=placement, pspecs=pspecs,
                                  wire=args.grad_wire, wire_policy=wire_policy)
    lr_schedule = linear_warmup_cosine(args.lr, max(args.steps // 20, 1), args.steps)
    step_fn = make_train_step(cfg, policy, opt, lr_schedule, grad_accum=args.grad_accum,
                              attn_chunk=min(1024, args.seq), transport=transport,
                              mesh=mesh)

    def batches(start_step):
        # step-keyed stream: a run starting at step k continues with batch k;
        # every rank draws the same global batch and computes its own rows
        return lm_batches(cfg.vocab, args.batch, args.seq, seed=args.seed,
                          start_step=start_step, device=device)

    return TrainRun(cfg, policy, opt, make_train_state(params, opt, transport=transport),
                    step_fn, batches, transport, mesh)


def loop_config(args, transport: TR.GradientTransport | None = None) -> TrainLoopConfig:
    """The loop's configuration from the launcher's flags (and the wire
    format of ``transport``)."""
    return TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every, seed=args.seed,
                           async_saves=not args.sync_ckpt, spike_factor=args.spike_factor,
                           spike_patience=args.spike_patience,
                           max_rollbacks=args.max_rollbacks,
                           preempt_poll_every=args.preempt_poll,
                           wire_format=getattr(transport, "wire_format", None))


def _silent(*_args, **_kwargs) -> None:
    """The log of every process but process 0."""


def train(args, run: TrainRun, *, log: Callable[[str], None] = print, fault_hook=None):
    """Run ``run`` to ``--steps`` and print the closing line (process 0
    logs, the others are silent)."""
    log = log if MH.is_primary() else _silent
    state, info = run_training(run.state, run.step_fn, run.batches,
                               loop_config(args, run.transport), log=log,
                               fault_hook=fault_hook, transport=run.transport)
    last = info["history"][-1] if info["history"] else {}
    log(f"[train] done at step {state.step}; final loss {last.get('loss', float('nan')):.4f}; "
        f"stragglers={info['stragglers']} preempted={info['preempted']} "
        f"rollbacks={info['rollbacks']}")
    return state, info


def main(argv=None):
    args = parse_args(argv)
    try:
        run = build(args)
        if MH.is_primary():
            wire = run.transport
            print(f"[train] {run.cfg.name} policy={run.policy.name} "
                  f"optimizer={run.optimizer.name} batch={args.batch} seq={args.seq} "
                  f"steps={args.steps} device={args.device} "
                  f"processes={MH.process_count()} "
                  f"mesh={run.mesh.shape if run.mesh else None} "
                  f"wire={wire.name}:{getattr(wire, 'wire_format', 'fp32')} "
                  f"x{wire.wire_replicas}")
        train(args, run)
    finally:
        MH.shutdown()


if __name__ == "__main__":
    main()
