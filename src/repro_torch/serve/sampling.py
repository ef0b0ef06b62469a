"""Per-request stochastic sampling: temperature / top-k / top-p (port of
``repro.serve.sampling``).

The engine's step keeps its greedy argmax (bitwise the greedy-only
step's); lanes with ``temperature > 0`` also read the step's output
logits and are re-decided here, on the logits' device, batched over the
step's sampling lanes. Only the chosen token ids cross to the host.

* **The key** of a generated token is a pure function of the request's
  ``(seed, rid)`` and the *absolute position* of the token being drawn:
  the 64-bit seed ``request_key(seed, rid, position)`` mixed by
  splitmix64, whose Philox4x32-10 words over the vocabulary
  (:mod:`repro_torch.kernels.philox`, the ``philox`` fill kernel on the
  card, its plain version on the CPU) are the draw's noise. Recompute
  preemption regenerates a lane's tokens from scratch; the logits are
  reproducible and the key depends only on position, so the regenerated
  sampled tokens equal the first pass's.
* **The draw** is Gumbel-max over the filtered logits: a word ``b`` maps
  to the uniform ``u = ((b >> 8) + ½) · 2⁻²⁴``, strictly inside (0, 1),
  and to the noise ``−log(−log u)``, in f64 so that the card and the CPU
  give the same noise; ``argmax(filtered + noise)`` is one categorical
  sample. No global RNG state anywhere.

The filter keeps the reference's order: temperature scales the logits,
top-k keeps every logit ``>=`` the k-th largest (ties included), top-p
keeps the smallest prefix, in stable descending order, whose softmax mass
reaches ``top_p`` (always at least one token). ``temperature == 0`` is
plain argmax. Torch's bits are not JAX's, so the two packages agree in
distribution and in the filter's support, not token for token.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.philox import M32, philox4x32_10, philox_bits, split_seed
from repro_torch.optim.base import _mix

__all__ = ["request_key", "validate_sampling", "filter_logits", "gumbel", "draw", "sample",
           "sample_token"]


def validate_sampling(temperature: float, top_k: int, top_p: float) -> None:
    """Raise ValueError on out-of-range sampling parameters."""
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0 (0 = off), got {top_k}")
    if not 0 < top_p <= 1:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def request_key(seed: int, rid: int, position: int) -> int:
    """The 64-bit seed of the token at absolute ``position`` (``len(prompt)
    + n_already_generated``) of request ``(seed, rid)``."""
    return _mix(seed, rid, position)


def to_device(values, dtype, device: torch.device) -> torch.Tensor:
    """A small host list as a tensor on ``device``; to a card through
    pinned memory without a sync."""
    t = torch.tensor(values, dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _words_ref(keys: Sequence[int], rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Plain version of the fill at chosen elements: word ``cols[m]`` of the
    stream of ``keys[rows[m]]`` (element i takes word i % 4 of block
    i // 4), as int64 holding u32."""
    k = torch.tensor([split_seed(s) for s in keys], dtype=torch.int64)[rows]
    j = cols // 4
    words = torch.stack(philox4x32_10((j & M32, j >> 32, 0, 0), (k[:, 0], k[:, 1])), dim=-1)
    return words.gather(1, (cols % 4)[:, None])[:, 0]


def _gumbel_of(words: torch.Tensor) -> torch.Tensor:
    """Gumbel noise of u32 words (int32 or int64): the top 24 bits as a
    uniform strictly inside (0, 1), then ``−log(−log u)`` in f64: in f32
    the card's draws parted from the CPU's on 1% of them, where ``log u``
    of a u near 1 is tiny; in f64 both logs resolve every 24-bit u."""
    u = (((words >> 8) & 0xFFFFFF).to(torch.float64) + 0.5) * 2.0 ** -24
    return -torch.log(-torch.log(u))


def gumbel(keys: Sequence[int], n: int, device) -> torch.Tensor:
    """(len(keys), n) f64 Gumbel noise, row r from the Philox stream of
    ``keys[r]``: the ``philox`` kernel on a card (one launch per row), the
    plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        rows = torch.arange(len(keys)).repeat_interleave(n)
        cols = torch.arange(n).repeat(len(keys))
        return _gumbel_of(_words_ref(keys, rows, cols)).reshape(len(keys), n)
    return _gumbel_of(torch.stack([philox_bits(s, (n,), device) for s in keys]))


def filter_logits(logits: torch.Tensor, temperature: Sequence[float],
                  top_k: Sequence[int], top_p: Sequence[float]) -> torch.Tensor:
    """(n, V) logits, row r filtered by ``temperature[r] > 0``, ``top_k[r]``
    and ``top_p[r]``: the scaled logits, ``-inf`` outside the support."""
    device = logits.device
    V = logits.shape[-1]
    ks = [int(k) if 0 < k < V else V for k in top_k]
    scaled = logits.to(torch.float32) / to_device(temperature, torch.float32, device)[:, None]
    cut_k = any(k < V for k in ks)
    cut_p = any(p < 1.0 for p in top_p)
    if not (cut_k or cut_p):
        return scaled
    vals, order = torch.sort(scaled, dim=-1, descending=True, stable=True)
    rank = torch.arange(V, device=device)[None, :]
    keep = torch.full((len(ks), 1), V, dtype=torch.int64, device=device)
    if cut_k:
        kth = vals.gather(1, to_device([k - 1 for k in ks], torch.int64, device)[:, None])
        keep = (vals >= kth).sum(-1, keepdim=True)
    if cut_p:
        # the kept prefix of the stable descending order is the top-k set
        mass = torch.cumsum(torch.softmax(torch.where(rank < keep, vals, -torch.inf), -1), -1)
        p = to_device(top_p, torch.float32, device)[:, None]
        n_p = (mass < p).sum(-1, keepdim=True) + 1
        keep = torch.where(p < 1.0, torch.minimum(keep, n_p), keep)
    mask = torch.zeros_like(scaled, dtype=torch.bool).scatter_(1, order, rank < keep)
    return torch.where(mask, scaled, -torch.inf)


def draw(filtered: torch.Tensor, keys: Sequence[int]) -> torch.Tensor:
    """Gumbel-max over (n, V) filtered logits, row r keyed by ``keys[r]``:
    (n,) int64. On the CPU the noise is drawn only where a row's logit is
    finite (the same words the full stream has there; elsewhere the
    argmax cannot land)."""
    if filtered.device.type != "cpu":
        return torch.argmax(filtered + gumbel(keys, filtered.shape[-1], filtered.device), -1)
    # argmax over the finite entries only, the first column among ties as
    # torch.argmax takes it; a row with none gives 0, as argmax of -inf does
    rows, cols = torch.nonzero(torch.isfinite(filtered), as_tuple=True)
    vals = filtered[rows, cols].to(torch.float64) + _gumbel_of(_words_ref(keys, rows, cols))
    n = filtered.shape[0]
    best = torch.full((n,), -torch.inf, dtype=torch.float64).scatter_reduce_(
        0, rows, vals, "amax")
    hit = vals == best[rows]
    return torch.zeros(n, dtype=torch.int64).scatter_reduce_(
        0, rows[hit], cols[hit], "amin", include_self=False)


def sample(logits: torch.Tensor, temperature: Sequence[float], top_k: Sequence[int],
           top_p: Sequence[float], keys: Sequence[int]) -> torch.Tensor:
    """One draw per row of (n, V) ``logits`` on their device: (n,) int64.
    Rows at ``temperature == 0`` take plain argmax."""
    hot = [i for i, t in enumerate(temperature) if t > 0]
    if len(hot) < len(temperature):
        out = torch.argmax(logits, dim=-1)
        if not hot:
            return out
        idx = to_device(hot, torch.int64, logits.device)
        drawn = sample(logits.index_select(0, idx),
                       *([seq[i] for i in hot] for seq in (temperature, top_k, top_p, keys)))
        return out.index_copy(0, idx, drawn)
    return draw(filter_logits(logits, temperature, top_k, top_p), keys)


def sample_token(logits, *, temperature: float, top_k: int = 0, top_p: float = 1.0,
                 key: int) -> int:
    """One draw from a (vocab,) logits row under ``key`` (a
    :func:`request_key`); ``temperature == 0`` is argmax."""
    row = torch.as_tensor(logits, dtype=torch.float32).reshape(1, -1)
    return int(sample(row, [temperature], [top_k], [top_p], [key])[0])
