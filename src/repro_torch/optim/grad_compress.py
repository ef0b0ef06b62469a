"""SR-compressed gradient collectives with Kahan error feedback (port of
``repro.optim.grad_compress``).

The paper's two primitives at the collective layer: each replica
stochastically rounds ``g + residual`` onto a low wire format before the
cross-replica mean, and the quantization error it dropped is carried to
the next step in an f32 error-feedback residual (Algorithm 3's mechanism
applied to communication). SR keeps the mean unbiased (E[q(g)] = g).

The wire format is any :class:`repro_torch.core.formats.FloatFormat`:
``bf16`` goes through the ``sr_cast`` kernel on the card with the leaf's
Philox bits (the route ``UpdateOps.q_sr`` takes); the sub-bf16 e8 formats
ride a bf16 carrier and fp16/e5m2/e4m3 an f16 one
(``wire_carrier_dtype``), rounded by the torch ops of
``round_stochastic`` after saturation at ``max_finite``
(``clamp_finite``: the narrow grids carry no ±inf); ``fp32`` is the
per-leaf keep, whose residual is zero.

**The mean.** The reference psums the carrier: XLA:CPU promotes a bf16
all-reduce to f32 and rounds the sum once, while NCCL's and gloo's 16-bit
sums round at every hop, in ring order. At n = 2 all of these agree (one
add); at n > 2 they need not. :func:`wire_mean` therefore does one
reduction on every backend and at every n: it all-gathers the carrier
payloads (the bytes on the wire stay the carrier's), sums them in rank
order in f32, rounds that sum once to the carrier (XLA:CPU's promoted
psum), and divides the f32 value by n. Every rank computes the same sum
of the same payloads, so the reduced gradients are bitwise equal across
ranks. A gloo group with CUDA tensors (several ranks rehearsed on one
card) gathers through host copies of the payloads, counted apart in
:class:`WireStats`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.formats import (BF16, FloatFormat, clamp_finite, round_stochastic,
                                      wire_carrier_dtype)
from repro_torch.kernels.sr_cast import sr_cast
from repro_torch.optim.base import LeafNoise, _mix

__all__ = ["WIRE_TAG", "WireKey", "WireStats", "init_residual", "compress_leaf",
           "wire_mean", "compressed_psum"]

# the reference folds 7 into a step's key for its wire (train/step.py)
WIRE_TAG = 7


class WireKey(NamedTuple):
    """The wire's random streams of one step on one replica: leaf ``i``
    rounds with the Philox stream of ``(seed, step, WIRE_TAG, replica, i)``.
    (The reference folds the replica's axis index into the step's wire key
    and splits it per leaf; the streams here are the port's own.)"""
    seed: int
    step: int
    replica: int = 0

    def leaf(self, i: int) -> LeafNoise:
        return LeafNoise(_mix(self.seed, self.step, WIRE_TAG, self.replica, i))


@dataclasses.dataclass
class WireStats:
    """What the wire moved: payload bytes sent per rank, by carrier dtype,
    and the seconds spent copying payloads between the card and the host
    (a gloo group with CUDA tensors)."""
    bytes_by_dtype: dict = dataclasses.field(default_factory=dict)
    host_copy_s: float = 0.0

    def count(self, t: torch.Tensor) -> None:
        name = str(t.dtype).replace("torch.", "")
        self.bytes_by_dtype[name] = self.bytes_by_dtype.get(name, 0) + t.numel() * t.element_size()


def init_residual(grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Zero error-feedback buffers (f32, one per gradient leaf)."""
    return [torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in grads]


def compress_leaf(g: torch.Tensor, residual: torch.Tensor, noise,
                  fmt: FloatFormat = BF16) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``g + residual`` onto ``fmt`` with SR; return
    ``(q, new_residual)``.

    ``q`` is in the format's carrier dtype (bf16 for e8 formats, f16 for
    fp16/e5m2/e4m3, f32 for the fp32 passthrough, whose residual is zero:
    nothing was dropped). ``noise`` is a leaf's randomness
    (:class:`~repro_torch.optim.base.LeafNoise` or a ``GivenKey`` leaf):
    u32 bits for the e8 and small-exponent grids, f32 uniforms for fp16
    and the small-exponent grids."""
    corrected = g.to(torch.float32) + residual
    if fmt.name == "fp32":
        return corrected, torch.zeros_like(corrected)
    corrected = corrected.contiguous()
    if fmt.name == "bf16":
        q = sr_cast(corrected, noise.bits(corrected.shape, corrected.device))
    else:
        needs_u = fmt.name == "fp16" or not fmt.is_f32_exponent
        q = round_stochastic(
            clamp_finite(corrected, fmt), fmt,
            noise=None if fmt.name == "fp16" else noise.bits(corrected.shape,
                                                              corrected.device),
            u=noise.uniform(corrected.shape, corrected.device) if needs_u else None,
        ).to(wire_carrier_dtype(fmt))
    return q, corrected - q.to(torch.float32)


def _gather(payload: torch.Tensor, group, stats: WireStats | None) -> list[torch.Tensor]:
    """Every rank's ``payload`` of ``group``, in rank order, on the
    payload's device. A gloo group gathers CUDA payloads through pinned
    host copies."""
    n = dist.get_world_size(group)
    via_host = payload.is_cuda and dist.get_backend(group) != "nccl"
    src = payload.contiguous()
    if via_host:
        t0 = time.perf_counter()
        torch.cuda.synchronize(payload.device)    # the copy's time, not the producer's
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src)
        src = host
        if stats is not None:
            stats.host_copy_s += time.perf_counter() - t0
    parts = [torch.empty(src.shape, dtype=src.dtype, device=src.device,
                         pin_memory=via_host) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    if stats is not None:
        stats.count(src)
    if via_host:
        t0 = time.perf_counter()
        parts = [p.to(payload.device) for p in parts]
        torch.cuda.synchronize(payload.device)
        if stats is not None:
            stats.host_copy_s += time.perf_counter() - t0
    return parts


def wire_mean(payload: torch.Tensor, group, stats: WireStats | None = None) -> torch.Tensor:
    """The f32 mean of ``payload`` over ``group``: the rank-order f32 sum
    of the gathered payloads, rounded once to the payload's dtype, then
    divided by n in f32 (see the module's note)."""
    parts = _gather(payload, group, stats)
    acc = parts[0].to(torch.float32, copy=True)
    for p in parts[1:]:
        acc += p.to(torch.float32)
    del parts
    return acc.to(payload.dtype).to(torch.float32) / dist.get_world_size(group)


def compressed_psum(grads: list[torch.Tensor], residuals: Sequence[torch.Tensor], key,
                    group, fmts: Sequence[FloatFormat] | None = None,
                    stats: WireStats | None = None) -> tuple[list, list]:
    """Low-format SR mean with error feedback over ``group``, leaf by leaf:
    ``grads`` (a list the caller gives up: each leaf is released once
    compressed) and ``residuals`` are this replica's leaves, ``key`` its
    randomness (``key.leaf(i)`` for leaf i), ``fmts`` the wire format per
    leaf (None: bf16 everywhere). Returns (f32 mean gradients, new
    residuals)."""
    if fmts is None:
        fmts = [BF16] * len(grads)
    out, new_res = [], []
    for i, (r, fmt) in enumerate(zip(residuals, fmts)):
        q, nr = compress_leaf(grads[i], r, key.leaf(i), fmt)
        grads[i] = None
        out.append(wire_mean(q, group, stats))
        new_res.append(nr)
        del q
    return out, new_res
