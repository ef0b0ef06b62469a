"""Deterministic synthetic datasets (port of ``repro.data.synthetic``:
``TokenStream``, ``lm_batches``, ``dlrm_batches`` and ``image_batches``),
and ``vlm_positions``, the 3-D M-RoPE positions of a text + image + text
sequence.

The stream is seeded, keyed by (seed, step) and *learnable*: an order-2
hash grammar over a Zipf unigram prior, so cross-entropy has real
headroom below the unigram entropy. The grammar and the prior are the
reference's (the same numpy draws from ``seed``, the same int32 hash with
wrap-around), and so are the per-batch uniforms: ``jax.random``'s bits
from the reference's key ``fold_in(PRNGKey(seed), step)``, drawn in numpy
(:mod:`repro_torch.core.jrandom`), so the tokens are the reference's bit
for bit. The DLRM click stream and the image blobs are
drawn with numpy alone, as the reference draws them, so their batches are
the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import jrandom

__all__ = ["TokenStream", "dlrm_batches", "image_batches", "lm_batches", "vlm_positions"]


@dataclasses.dataclass
class TokenStream:
    vocab: int
    order: int = 2
    seed: int = 0
    zipf_a: float = 1.1

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # hidden transition: next-token depends on hash of last `order`
        self._mix = rng.integers(1, 2**31 - 1, size=self.order, dtype=np.int64)
        self._shift = int(rng.integers(0, self.vocab))
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = ranks ** (-self.zipf_a)
        self._p = p / p.sum()
        self._cdf = np.cumsum(self._p).astype(np.float32)

    def from_uniform(self, u: np.ndarray) -> np.ndarray:
        """(B, S+1) int32 tokens from f32 uniforms u of shape
        (B, S+1+order): a Zipf sample by inverse CDF, then the grammar."""
        base = np.searchsorted(self._cdf, np.asarray(u, np.float32)).astype(np.int32)
        mix = self._mix.astype(np.int32)
        hist = base[:, :self.order]
        toks = []
        with np.errstate(over="ignore"):
            for b in base[:, self.order:].T:
                # with p=0.5 the next token is a hash of the history (int32
                # arithmetic wrapping as the reference's), else the sample
                h = np.sum(hist * mix, axis=-1, dtype=np.int32) % np.int32(self.vocab)
                tok = np.where((b + h) % 2 == 0, h, b).astype(np.int32)
                hist = np.concatenate([hist[:, 1:], tok[:, None]], axis=1)
                toks.append(tok)
        return np.stack(toks, axis=1)

    def batch(self, key, batch: int, seq: int) -> np.ndarray:
        """(B, S+1) int32 — callers split into tokens/labels. ``key`` is a
        :mod:`~repro_torch.core.jrandom` key; its first split key draws the
        uniforms, as the reference's ``TokenStream.batch`` does."""
        k1, _ = jrandom.split(key)
        return self.from_uniform(jrandom.uniform(k1, (batch, seq + 1 + self.order)))


def lm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
               start_step: int = 0, device=None) -> Iterator[dict]:
    """Step-keyed LM stream on ``device`` (CUDA unless ``"cpu"``): batch i
    is a pure function of (seed, i), so ``start_step=k`` yields exactly the
    suffix of the ``start_step=0`` stream from batch k on — the resume
    contract. Yields ``{"tokens", "labels"}`` int32 (B, S): the reference's
    ``lm_batches`` bit for bit."""
    dev = resolve_device(device)
    stream = TokenStream(vocab, seed=seed)
    key = jrandom.PRNGKey(seed)
    i = start_step
    while True:
        toks = torch.from_numpy(stream.batch(jrandom.fold_in(key, i), batch, seq)).to(dev)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        i += 1


def dlrm_batches(cfg: dict, batch: int, *, seed: int = 0, device=None) -> Iterator[dict]:
    """Click model on ``device`` (CUDA unless ``"cpu"``): y ~ Bernoulli(σ(w·dense
    + Σ table_effects)). Yields ``dense`` f32 (B, n_dense), ``sparse`` int32
    (B, n_sparse) and ``labels`` f32 (B,): the reference's numbers."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    w = rng.normal(size=cfg["n_dense"]) / np.sqrt(cfg["n_dense"])
    table_fx = rng.normal(size=(cfg["n_sparse"], cfg["vocab_per_table"])) * 0.5
    i = 0
    while True:
        r = np.random.default_rng(seed * 1000003 + i)
        dense = r.normal(size=(batch, cfg["n_dense"])).astype(np.float32)
        sparse = r.integers(0, cfg["vocab_per_table"],
                            size=(batch, cfg["n_sparse"]), dtype=np.int32)
        logit = dense @ w + table_fx[np.arange(cfg["n_sparse"])[None, :], sparse].sum(-1)
        y = (r.uniform(size=batch) < 1 / (1 + np.exp(-logit))).astype(np.float32)
        yield {"dense": torch.from_numpy(dense).to(dev),
               "sparse": torch.from_numpy(sparse).to(dev),
               "labels": torch.from_numpy(y).to(dev)}
        i += 1


def image_batches(classes: int, batch: int, *, res: int = 32, seed: int = 0,
                  device=None) -> Iterator[dict]:
    """Class-conditional Gaussian blobs (the CIFAR stand-in) on ``device``
    (CUDA unless ``"cpu"``): ``images`` f32 (B, res, res, 3) and
    ``labels`` int32 (B,), the reference's numpy draws bit for bit."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(classes, res, res, 3)).astype(np.float32)
    i = 0
    while True:
        r = np.random.default_rng(seed * 7 + i)
        y = r.integers(0, classes, size=batch)
        x = protos[y] + 0.8 * r.normal(size=(batch, res, res, 3)).astype(np.float32)
        yield {"images": torch.from_numpy(x).to(dev),
               "labels": torch.from_numpy(y.astype(np.int32)).to(dev)}
        i += 1


def vlm_positions(batch: int, n_text: int, grid: int, n_after: int, *,
                  device=None) -> torch.Tensor:
    """(3, batch, n_text + grid² + n_after) int32 M-RoPE positions on
    ``device`` (CUDA unless ``"cpu"``): a text run (t = h = w = i), a
    1 × grid × grid image (t at the run's next position, h and w that plus
    the row and the column), then text from the grid's largest position
    plus one."""
    text = np.arange(n_text)
    r, c = np.divmod(np.arange(grid * grid), grid)
    img = np.stack([np.full_like(r, n_text), n_text + r, n_text + c])
    after = n_text + grid + np.arange(n_after)
    pos = np.concatenate([np.stack([text] * 3), img, np.stack([after] * 3)], axis=1)
    pos = np.broadcast_to(pos[:, None], (3, batch, pos.shape[1])).astype(np.int32)
    return torch.from_numpy(pos.copy()).to(resolve_device(device))
