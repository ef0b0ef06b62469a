"""Optimizer substrate: policy-aware quantized update arithmetic (port of
``repro.optim.base``).

Every line of the paper's Algorithms 2–5 is one FPU op: bf16 (or sub-16)
inputs, f32 accumulator, output rounded once to the storage format.
:class:`UpdateOps` encodes that contract:

* ``q(x)``           — nearest-round ``x`` onto the state/param grid
* ``q_sr(x, noise)`` — stochastically round (the paper's ⊖ output mode)
* ``f32(x)``         — read a stored tensor into the 32-bit accumulator

Randomness. The reference splits one JAX key per leaf; the port keys one
random stream per leaf instead: :class:`StepKey` ``(seed, step)`` gives
leaf ``i`` a 64-bit seed mixed from ``(seed, step, i)``, and its u32 SR
bits are the words of that seed's Philox4x32-10 stream
(:mod:`repro_torch.kernels.philox`: element k takes word k % 4 of block
k // 4). :meth:`LeafNoise.bits` fills them (the ``philox`` kernel on the
card); the fused AdamW kernel draws the same words itself from the seed,
so the non-fused optimizers, fused SGD and fused AdamW all round with the
same bits. The bits differ from ``jax.random``'s; to compare with the
reference bit for bit, pass a :class:`GivenKey` holding the reference's
own bits.

On the card, ``q_sr`` onto native bf16 launches the ``sr_cast`` CUDA kernel
with those bits (the same function as the reference's bf16 bit trick).

The optimizers update **in place**: ``update`` writes each leaf's new
weights and state into the tensors it was given (after computing all of the
leaf's new values) and returns them, so a step never holds a second copy
of the optimizer state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import torch

from repro_torch.core.formats import FloatFormat, round_nearest, round_stochastic
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.kernels.philox import philox_bits
from repro_torch.kernels.sr_cast import sr_cast
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["UpdateOps", "Optimizer", "LeafNoise", "StepKey", "GivenKey", "ShardNoise",
           "ShardKey",
           "leafwise", "state_ops", "param_ops", "init_params_for_policy",
           "write_back"]

PyTree = Any
_M64 = (1 << 64) - 1


def _mix(*ints: int) -> int:
    """splitmix64 over the integers: a 63-bit generator seed."""
    h = 0x9E3779B97F4A7C15
    for v in ints:
        h = (h ^ (int(v) & _M64)) & _M64
        h = (h + 0x9E3779B97F4A7C15) & _M64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _M64
        h ^= h >> 31
    return h >> 1


class LeafNoise:
    """The SR randomness of one leaf: u32 bits (int32), the Philox stream of
    the leaf's 64-bit ``seed``, and, for the fp16 and small-exponent grids,
    f32 uniforms from a generator seeded from it, on the device they are
    drawn for. A kernel that draws its own bits takes ``seed``."""

    def __init__(self, seed: int):
        self.seed = seed

    def bits(self, shape, device) -> torch.Tensor:
        return philox_bits(self.seed, shape, device)

    def uniform(self, shape, device) -> torch.Tensor:
        gen = torch.Generator(device=device)
        gen.manual_seed(_mix(self.seed, 1))
        return torch.rand(shape, generator=gen, device=device)


class StepKey(NamedTuple):
    """Per-leaf random streams of one training step."""
    seed: int
    step: int

    def leaf(self, i: int) -> LeafNoise:
        return LeafNoise(_mix(self.seed, self.step, i))


class _GivenNoise:
    seed = None            # no stream: the bits are given

    def __init__(self, bits, uniform):
        self._bits, self._uniform = bits, uniform

    @staticmethod
    def _take(t, what, shape, device):
        if t is None:
            raise ValueError(f"no {what} given for this leaf")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what} of shape {tuple(t.shape)} for a leaf of "
                             f"shape {tuple(shape)}")
        return t.to(device)

    def bits(self, shape, device):
        return self._take(self._bits, "bits", shape, device)

    def uniform(self, shape, device):
        return self._take(self._uniform, "uniforms", shape, device)


class GivenKey:
    """Explicit per-leaf randomness, in leaf order: ``bits[i]`` (int32 or
    int64 tensors carrying u32) and optionally ``uniform[i]`` (f32). Used to
    feed both frameworks the same bits."""

    def __init__(self, bits: Sequence, uniform: Sequence | None = None):
        self._bits = list(bits)
        self._uniform = list(uniform) if uniform is not None else [None] * len(self._bits)

    def leaf(self, i: int) -> _GivenNoise:
        return _GivenNoise(self._bits[i], self._uniform[i])


class ShardNoise:
    """A leaf's randomness on a shard of it (FSDP): the leaf stream's words
    at the shard's global positions — the shard along ``dim`` from
    ``start`` of a leaf of ``full_shape`` — so a sharded update rounds
    every element with the bits the whole leaf's update gives it (the
    reference draws ``jax.random.bits`` over the global leaf). ``seed`` is
    the leaf's: the shard-local fused kernels fold it per shard instead."""

    def __init__(self, noise: LeafNoise, full_shape, dim: int, start: int):
        self.seed = noise.seed
        self._noise = noise
        self.full_shape, self.dim, self.start = tuple(full_shape), dim, start

    def bits(self, shape, device) -> torch.Tensor:
        return philox_bits(self.seed, shape, device, full_shape=self.full_shape,
                           dim=self.dim, start=self.start)

    def uniform(self, shape, device) -> torch.Tensor:
        full = self._noise.uniform(self.full_shape, device)
        return full.narrow(self.dim, self.start, shape[self.dim]).contiguous()


class ShardKey:
    """A step key over the shards of a sharded tree: leaf ``i`` sits in its
    full leaf as ``shards[i]`` = ``(full_shape, dim, start)`` (None: the
    whole leaf). A leaf with given bits keeps them (they are the shard's)."""

    def __init__(self, key, shards: Sequence):
        self.key, self.shards = key, list(shards)

    def leaf(self, i: int):
        noise = self.key.leaf(i)
        if self.shards[i] is None or noise.seed is None:
            return noise
        return ShardNoise(noise, *self.shards[i])


class UpdateOps:
    def __init__(self, fmt: FloatFormat, native_dtype: torch.dtype):
        self.fmt = fmt
        self._dtype = native_dtype
        self._native = fmt.name in ("bf16", "fp16", "fp32")

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    def f32(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float32)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """One FPU op output: nearest-round onto the grid, stored."""
        if self._native:
            return x.to(self._dtype)
        return round_nearest(self.f32(x), self.fmt)

    def q_sr(self, x: torch.Tensor, noise) -> torch.Tensor:
        """One FPU op output with stochastic rounding, randomness from
        ``noise`` (a leaf's :class:`LeafNoise`)."""
        if self.fmt.name == "fp32":
            return x.to(self._dtype)
        x = self.f32(x).contiguous()
        if self.fmt.name == "bf16" and self._dtype == torch.bfloat16:
            return sr_cast(x, noise.bits(x.shape, x.device))
        needs_u = self.fmt.name == "fp16" or not self.fmt.is_f32_exponent
        y = round_stochastic(
            x, self.fmt,
            noise=None if self.fmt.name == "fp16" else noise.bits(x.shape, x.device),
            u=noise.uniform(x.shape, x.device) if needs_u else None)
        return y.to(self._dtype) if self._native else y

    def zeros_like(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros(x.shape, dtype=self._dtype, device=x.device)


def state_ops(policy: PrecisionPolicy) -> UpdateOps:
    return UpdateOps(policy.state_format, policy.state_dtype)


def param_ops(policy: PrecisionPolicy) -> UpdateOps:
    if policy.master_weights:
        return UpdateOps(policy.param_format, torch.float32)
    return UpdateOps(policy.param_format, policy.param_dtype)


def leafwise(fn: Callable, params: PyTree, *trees: PyTree | None, key) -> list[PyTree]:
    """Apply ``fn(w, *leaves, noise)`` per parameter leaf across aligned
    trees, ``noise = key.leaf(i)`` for leaf ``i``. ``fn`` returns a tuple;
    the result is a list of trees (one per tuple slot). Trees passed as
    ``None`` contribute ``None`` leaves."""
    p_leaves = tree_leaves(params)
    cols = [[None] * len(p_leaves) if t is None else tree_leaves(t) for t in trees]
    outs = [fn(w, *[c[i] for c in cols], key.leaf(i)) for i, w in enumerate(p_leaves)]
    return [tree_unflatten(params, [o[j] for o in outs]) for j in range(len(outs[0]))]


def write_back(dst: torch.Tensor | None, src: torch.Tensor | None):
    """Store a leaf's new value into its old tensor (the in-place update).
    A new value of another dtype replaces the leaf instead, as in the
    reference: an f32 leaf of a 16-bit tree (the MoE router, Mamba's
    ``A_log``/``D_skip``, RG-LRU's ``lambda``) leaves its first update in
    the storage dtype."""
    if dst is None:
        return None
    if src.dtype != dst.dtype:
        return src
    if src is not dst:
        dst.copy_(src)
    return dst


def init_params_for_policy(params_f32: PyTree, policy: PrecisionPolicy) -> PyTree:
    """Cast freshly-initialized f32 params onto the policy's storage grid."""
    return tree_map(param_ops(policy).q, params_f32)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init`` builds state, ``update`` applies one step of the policy's
    Algorithm (2–5 / exact / mixed):
    ``update(grads, state, params, *, step, key, lr) -> (params, state)``,
    with params and state updated in place."""

    name: str
    policy: PrecisionPolicy
    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple[PyTree, PyTree]]
