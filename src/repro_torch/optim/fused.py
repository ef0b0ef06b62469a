"""Kernel-backed optimizers: the fused-update path (port of
``repro.optim.fused``).

Same interface as :func:`repro_torch.optim.sgd` / :func:`adamw`, but each
leaf update is ONE launch of a hand-written CUDA kernel
(``kernels/fused_sgd.py``, ``kernels/fused_adamw.py``): one pass over
w, m, (v,) g, (c) and the SR bits — Appendix B's efficiency argument.
Only native-bf16 policies are supported (the kernels implement the bf16
grid). Given the same per-leaf bits, the result equals the reference
optimizers' bit for bit: the kernels round every op as they do and
contract no multiply-add.

Fused AdamW draws a ``StepKey`` leaf's SR bits inside its kernel from the
leaf's seed (the Philox stream that ``LeafNoise.bits`` fills), so they never
pass through device memory; a ``GivenKey`` leaf's bits are read from its
tensor. Fused SGD takes each leaf's bits from ``key.leaf(i).bits``, used
and freed before the next leaf's. w, m, v, c are updated in place, so a
step holds no second copy of the optimizer state. The kernels take 16-bit
leaves: an f32 leaf of the tree (the MoE router, Mamba's ``A_log`` and
``D_skip``, RG-LRU's ``lambda``) is cast to bf16 and updated as such, and
its bf16 result replaces the leaf — what the reference's wrappers do
(``repro/kernels/fused_adamw.py:105``: every operand padded as bf16).

Shard-local mode (``mesh=``/``pspecs=``): each rank's launches run on its
own contiguous shard of (w, m, v, g, c), as the reference's run inside
``shard_map`` on each device's shard. A leaf whose spec names mesh axes
has its seed folded with the shard's index linearised over exactly those
axes (``_mix(seed, idx)``, the counterpart of the reference's
``_shard_key``), so its shards draw distinct bits; a replicated leaf
(``P()``, every leaf of a data-parallel mesh) draws the same bits on every
rank, and the replicas stay bitwise equal. As in the reference, a fused
FSDP run is therefore not bitwise its fused data-parallel run (the
non-fused update is: :class:`~repro_torch.optim.base.ShardKey`). A
``GivenKey`` leaf carries its shard's own bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import PrecisionPolicy
from repro_torch.kernels.fused_adamw import fused_adamw
from repro_torch.kernels.fused_sgd import fused_sgd
from repro_torch.optim.adamw import AdamWState, init_state, snap
from repro_torch.optim.base import LeafNoise, Optimizer, _mix, state_ops
from repro_torch.optim.sgd import SGDState
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["fused_sgd_optimizer", "fused_adamw_optimizer"]


def _check(policy: PrecisionPolicy, mesh, pspecs):
    if policy.param_format.name != "bf16" or policy.update_rounding == "exact":
        raise ValueError(
            f"fused kernels implement the bf16 16-bit-FPU recipe; "
            f"policy {policy.name!r} is not supported")
    if (mesh is None) != (pspecs is None):
        raise ValueError("shard-local mode needs both mesh= and pspecs=")


def _shard_indices(mesh, pspecs, n_leaves: int) -> list[int | None]:
    """Per leaf, the shard's index linearised over the axes its spec names,
    in dim order (None for a replicated leaf, or without a mesh)."""
    if pspecs is None:
        return [None] * n_leaves
    out = []
    for spec in tree_leaves(pspecs):
        idx = None
        for ax in spec.axes:
            idx = (idx or 0) * mesh.shape[ax] + (mesh.index(ax) if mesh.shape[ax] > 1 else 0)
        out.append(idx)
    return out


def _noise(key, i: int, idx: int | None):
    """Leaf i's randomness on this rank: a seeded leaf's stream, its seed
    folded with the shard index ``idx``; a given leaf's bits as given."""
    leaf = key.leaf(i)
    if leaf.seed is None or idx is None:
        return leaf if leaf.seed is None else LeafNoise(leaf.seed)
    return LeafNoise(_mix(leaf.seed, idx))


def _leaves(params, *trees):
    """Per-leaf tuples across aligned trees (None trees give None)."""
    cols = [tree_leaves(params)]
    cols += [[None] * len(cols[0]) if t is None else tree_leaves(t) for t in trees]
    return list(zip(*cols))


def _bf16(w: torch.Tensor) -> torch.Tensor:
    """The leaf the kernel updates: ``w`` itself, or a bf16 copy of an f32
    leaf (which then replaces it)."""
    return w if w.dtype == torch.bfloat16 else w.to(torch.bfloat16)


def _grad(g: torch.Tensor) -> torch.Tensor:
    """The gradient as the kernels read it: bf16, contiguous (autograd
    leaves the gradient of a permuted view, a convolution's kernel,
    strided)."""
    return g.to(torch.bfloat16).contiguous()


def fused_sgd_optimizer(policy: PrecisionPolicy, *, momentum: float = 0.9,
                        weight_decay: float = 0.0, mesh=None,
                        pspecs=None) -> Optimizer:
    _check(policy, mesh, pspecs)
    sops = state_ops(policy)
    stochastic = policy.update_rounding == "stochastic"

    def init(params):
        m = tree_map(sops.zeros_like, params)
        c = tree_map(sops.zeros_like, params) if policy.kahan else None
        return SGDState(m, c)

    def update(grads, state, params, *, step, key, lr):
        del step
        new_w = []
        leaves = _leaves(params, grads, state.momentum, state.kahan_c)
        shard = _shard_indices(mesh, pspecs, len(leaves))
        with torch.no_grad():
            for i, (w, g, m, c) in enumerate(leaves):
                bits = (_noise(key, i, shard[i]).bits(w.shape, w.device) if stochastic
                        else None)
                new_w.append(_bf16(w))
                fused_sgd(new_w[-1], m, _grad(g), c=c, bits=bits,
                          stochastic=stochastic, lr=lr, momentum=momentum,
                          wd=weight_decay)
                del bits
        return tree_unflatten(params, new_w), state

    return Optimizer(f"fused_sgd[{policy.name}]", policy, init, update)


def fused_adamw_optimizer(policy: PrecisionPolicy, *, b1: float = 0.9,
                          b2: float = 0.99609375, eps: float = 1e-8,
                          weight_decay: float = 0.01, mesh=None,
                          pspecs=None) -> Optimizer:
    _check(policy, mesh, pspecs)
    sops = state_ops(policy)
    stochastic = policy.update_rounding == "stochastic"
    b1q, b2q = snap(sops, b1), snap(sops, b2)

    def init(params):
        return init_state(sops, sops, params, policy.kahan)

    def update(grads, state, params, *, step, key, lr):
        del step
        with torch.no_grad():
            c1 = sops.q(sops.f32(state.c1) * b1q)
            c2 = sops.q(sops.f32(state.c2) * b2q)
            c1f, c2f = float(c1), float(c2)       # one host read per step
            new_w = []
            leaves = _leaves(params, grads, state.m, state.v, state.kahan_c)
            shard = _shard_indices(mesh, pspecs, len(leaves))
            for i, (w, g, m, v, c) in enumerate(leaves):
                noise = dict()
                if stochastic:
                    leaf = _noise(key, i, shard[i])
                    noise = (dict(seed=leaf.seed) if leaf.seed is not None
                             else dict(bits=leaf.bits(w.shape, w.device)))
                new_w.append(_bf16(w))
                fused_adamw(new_w[-1], m, v, _grad(g), c=c,
                            stochastic=stochastic, lr=lr, b1=b1q, b2=b2q, eps=eps,
                            wd=weight_decay, c1=c1f, c2=c2f, **noise)
                del noise
        return tree_unflatten(params, new_w), AdamWState(state.m, state.v, c1, c2,
                                                         state.kahan_c)

    return Optimizer(f"fused_adamw[{policy.name}]", policy, init, update)
