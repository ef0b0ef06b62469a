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

**The reduce-scatter** (FSDP's gradient reduction, :func:`reduce_scatter_mean`)
keeps that arithmetic: each rank sends chunk j of its payload to rank j
(``all_to_all_single``), sums the n chunks it receives in rank order in
f32, rounds once to the payload's dtype and divides by n, so a shard's
elements equal the same elements of :func:`wire_mean`'s result, on every
rank that holds the shard and on every backend. ``reduce_scatter_tensor``
is not used: its summation order is the backend's. A rank holds its
payload and the n received chunks (one leaf's worth), never n leaves.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.formats import (BF16, FloatFormat, clamp_finite, round_stochastic,
                                      wire_carrier_dtype)
from repro_torch.kernels.sr_cast import sr_cast
from repro_torch.optim.base import LeafNoise, _mix

__all__ = ["WIRE_TAG", "WireKey", "WireStats", "init_residual", "compress_leaf",
           "gather_parts", "exchange_parts", "exchange_bytes", "wire_mean", "reduce_scatter_mean",
           "compressed_psum"]

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
    """What the collectives moved, per rank: the gradient payloads (wire
    means and reduce-scatters) by carrier dtype, the reduce-scatters' share
    of them, the share by dtype of the train step's f32 mean over the data
    axes the wire does not reduce (``kind="mean"``: the mean the reference
    leaves to GSPMD inside its backward, so its lowered module has no
    collective for it), the FSDP gathers of the working copy by dtype, and
    the seconds spent copying payloads between the card and the host (a
    gloo group with CUDA tensors). A payload counts once, at the size this
    rank hands the collective."""
    bytes_by_dtype: dict = dataclasses.field(default_factory=dict)
    scatter_bytes: int = 0
    mean_bytes_by_dtype: dict = dataclasses.field(default_factory=dict)
    gather_bytes_by_dtype: dict = dataclasses.field(default_factory=dict)
    host_copy_s: float = 0.0

    def count(self, t: torch.Tensor, kind: str = "reduce") -> None:
        name = str(t.dtype).replace("torch.", "")
        nbytes = t.numel() * t.element_size()
        into = self.gather_bytes_by_dtype if kind == "gather" else self.bytes_by_dtype
        into[name] = into.get(name, 0) + nbytes
        if kind == "scatter":
            self.scatter_bytes += nbytes
        elif kind == "mean":
            self.mean_bytes_by_dtype[name] = self.mean_bytes_by_dtype.get(name, 0) + nbytes

    def wire_bytes_by_dtype(self) -> dict:
        """The gradient payloads less the step's mean over the data axes:
        what the wire moved (the reference's explicit all-reduces)."""
        out = {k: n - self.mean_bytes_by_dtype.get(k, 0) for k, n in self.bytes_by_dtype.items()}
        return {k: n for k, n in out.items() if n}


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


def _via_host(payload: torch.Tensor, group) -> bool:
    """A gloo group moves CUDA payloads through host memory."""
    return payload.is_cuda and dist.get_backend(group) != "nccl"


def _to_host(src: torch.Tensor, stats: WireStats | None) -> torch.Tensor:
    """A pinned host copy of a CUDA payload, its time counted apart."""
    t0 = time.perf_counter()
    torch.cuda.synchronize(src.device)      # the copy's time, not the producer's
    host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    host.copy_(src)
    if stats is not None:
        stats.host_copy_s += time.perf_counter() - t0
    return host


def _to_device(parts, device, stats: WireStats | None):
    t0 = time.perf_counter()
    parts = [p.to(device) for p in parts]
    torch.cuda.synchronize(device)
    if stats is not None:
        stats.host_copy_s += time.perf_counter() - t0
    return parts


def gather_parts(payload: torch.Tensor, group, stats: WireStats | None = None,
                 kind: str = "reduce") -> list[torch.Tensor]:
    """Every rank's ``payload`` of ``group``, in rank order, on the
    payload's device (counted in ``stats`` as ``kind``). A gloo group
    gathers CUDA payloads through pinned host copies."""
    n = dist.get_world_size(group)
    via_host = _via_host(payload, group)
    src = payload.contiguous()
    if via_host:
        src = _to_host(src, stats)
    parts = [torch.empty(src.shape, dtype=src.dtype, device=src.device,
                         pin_memory=via_host) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    if stats is not None:
        stats.count(src, kind)
    if via_host:
        parts = _to_device(parts, payload.device, stats)
    return parts


def exchange_parts(send: torch.Tensor, to: Sequence[int], frm: Sequence[int], group,
                   stats: WireStats | None = None, kind: str = "reduce") -> torch.Tensor:
    """An all-to-all of equal parts: part j of ``send`` (its dim 0) goes
    to rank ``to[j]`` of ``group``, and part i of the result comes from
    rank ``frm[i]`` (``all_to_all_single`` with uneven splits; each rank
    hands every rank at most one part). Counted in ``stats`` as ``kind``."""
    n = dist.get_world_size(group)
    if sorted(set(to)) != sorted(to) or sorted(set(frm)) != sorted(frm):
        raise ValueError(f"a rank takes at most one part: to {to}, from {frm}")
    ins = sorted(range(len(to)), key=lambda j: to[j])
    outs = sorted(range(len(frm)), key=lambda i: frm[i])
    src = send[ins].contiguous()
    via_host = _via_host(send, group)
    if via_host:
        src = _to_host(src, stats)
    recv = torch.empty((len(frm), *send.shape[1:]), dtype=send.dtype, device=src.device,
                       pin_memory=via_host)
    dist.all_to_all_single(recv, src, output_split_sizes=[int(r in frm) for r in range(n)],
                           input_split_sizes=[int(r in to) for r in range(n)], group=group)
    if stats is not None:
        stats.count(src, kind)
    if via_host:
        recv = _to_device([recv], send.device, stats)[0]
    out = torch.empty_like(recv)
    out[outs] = recv
    return out


def exchange_bytes(parts: Sequence[torch.Tensor], recv_sizes: Sequence[int], group,
                   stats: WireStats | None = None, kind: str = "reduce") -> list[torch.Tensor]:
    """An all-to-all of uneven byte parts: ``parts[j]`` (a u8 tensor, empty
    for none) goes to rank j of ``group``, and part i of the result holds
    the ``recv_sizes[i]`` bytes rank i sent this one (``all_to_all_single``
    with uneven splits). Counted in ``stats`` as ``kind``, at the bytes
    this rank hands the collective."""
    device = parts[0].device
    send = torch.cat([p.reshape(-1) for p in parts])
    via_host = _via_host(send, group)
    if via_host:
        send = _to_host(send, stats)
    recv = torch.empty((sum(recv_sizes),), dtype=torch.uint8, device=send.device,
                       pin_memory=via_host)
    dist.all_to_all_single(recv, send, output_split_sizes=list(recv_sizes),
                           input_split_sizes=[p.numel() for p in parts], group=group)
    if stats is not None:
        stats.count(send, kind)
    if via_host:
        recv = _to_device([recv], device, stats)[0]
    return list(torch.split(recv, list(recv_sizes)))


def wire_mean(payload: torch.Tensor, group, stats: WireStats | None = None,
              kind: str = "reduce") -> torch.Tensor:
    """The f32 mean of ``payload`` over ``group``: the rank-order f32 sum
    of the gathered payloads, rounded once to the payload's dtype, then
    divided by n in f32 (see the module's note); counted as ``kind``."""
    parts = gather_parts(payload, group, stats, kind)
    acc = parts[0].to(torch.float32, copy=True)
    for p in parts[1:]:
        acc += p.to(torch.float32)
    del parts
    return acc.to(payload.dtype).to(torch.float32) / dist.get_world_size(group)


def reduce_scatter_mean(payload: torch.Tensor, dim: int, group,
                        stats: WireStats | None = None) -> torch.Tensor:
    """This rank's chunk of :func:`wire_mean` ``(payload, group)``: the
    payload split into n equal chunks along ``dim``, rank r of the group
    keeping chunk r. Each rank receives every rank's copy of its chunk
    (``all_to_all_single``), sums them in rank order in f32, rounds the sum
    once to the payload's dtype and divides by n in f32."""
    n = dist.get_world_size(group)
    shape = tuple(payload.shape)
    if shape[dim] % n:
        raise ValueError(f"dim {dim} of a {shape} payload does not split {n} ways")
    outer = math.prod(shape[:dim])
    ext = shape[dim] // n
    # (n, outer, ext, inner): chunk j, for rank j, leading and contiguous
    send = payload.reshape(outer, n, ext, -1).transpose(0, 1).contiguous()
    via_host = _via_host(payload, group)
    if via_host:
        send = _to_host(send, stats)
    recv = torch.empty(send.shape, dtype=send.dtype, device=send.device, pin_memory=via_host)
    dist.all_to_all_single(recv, send, group=group)
    if stats is not None:
        stats.count(send, "scatter")
    del send
    if via_host:
        recv = _to_device([recv], payload.device, stats)[0]
    acc = recv[0].to(torch.float32, copy=True)
    for p in recv[1:]:
        acc += p.to(torch.float32)
    del recv
    out_shape = shape[:dim] + (ext,) + shape[dim + 1:]
    return (acc.to(payload.dtype).to(torch.float32) / n).reshape(out_shape)


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
