"""Shared benchmark utilities (port of ``benchmarks/common.py``): timing,
CSV rows and the two small train harnesses of the paper's sections.

Rows print as the reference's ``name,us_per_call,derived`` under the
reference's row names, so the two runs diff line by line. The harnesses
take the reference's settings; their weights, LM tokens and SR bits are
the port's own draws from ``seed`` (the DLRM batches are the reference's
numbers). Both harnesses draw their weights on the CPU, and the SR bits
of the bf16 and sub-16 grids are Philox words, so a run starts from the
same weights and rounds with the same bits on every device (fp16's SR
uniforms come from the device's generator). ``init_params=`` replaces the drawn f32
weights, so a test can start both packages from the same ones.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import jrandom
from repro_torch.core.policy import get_policy
from repro_torch.core.qarith import QArith
from repro_torch.data.synthetic import dlrm_batches, lm_batches
from repro_torch.models import registry as R
from repro_torch.models.dlrm import DLRM_KAGGLE_SMALL, dlrm_apply, dlrm_init
from repro_torch.optim import StepKey, adamw, constant, sgd
from repro_torch.optim.base import init_params_for_policy
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import make_train_state
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["row", "time_fn", "train_tiny_lm", "train_dlrm", "dlrm_loss", "auc"]


def row(name: str, us_per_call: float, derived) -> None:
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def _sync() -> None:
    """Wait for the card, if this process has used one: a host clock read
    after it covers the device's work."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn, *args, iters: int = 20, warmup: int = 3) -> float:
    """µs per call of ``fn(*args)``, the device's work included."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters * 1e6


def train_tiny_lm(policy_name: str, *, steps: int = 200, seed: int = 0,
                  lr: float = 3e-3, batch: int = 8, seq: int = 32,
                  init_scale: float | None = None, device=None, init_params=None):
    """Train the reduced qwen2.5 config on the synthetic LM stream.

    Returns (losses, final_eval_loss, us_per_step); the time per step is
    the host's clock over every step, each ending in the read of its loss."""
    dev = resolve_device(device)
    policy = get_policy(policy_name)
    cfg = R.get_config("qwen2.5-3b").reduced()
    if init_params is None:     # drawn on the CPU: the same weights on every device
        init_params = tree_map(lambda w: w.to(dev),
                               R.init(cfg, seed, torch.float32, device="cpu"))
    params = init_params
    if init_scale is not None:
        params = tree_map(lambda w: w * init_scale, params)
    params = init_params_for_policy(params, policy)
    opt = adamw(policy, b2=0.997)
    state = make_train_state(params, opt)
    step = make_train_step(cfg, policy, opt, constant(lr), attn_chunk=8)
    losses = []
    _sync()
    t0 = time.perf_counter()
    for i, b in enumerate(lm_batches(cfg.vocab, batch, seq, seed=seed, device=dev)):
        if i >= steps:
            break
        state, m = step(state, b, seed)
        losses.append(float(m["loss"]))
    dt_us = (time.perf_counter() - t0) / max(len(losses), 1) * 1e6
    final = sum(losses[-10:]) / 10
    return losses, final, dt_us


def dlrm_loss(qa: QArith, params, batch) -> torch.Tensor:
    """Mean stable logistic loss, with the reference's dtype promotion: the
    logits stay in the compute dtype, ``logits * y`` promotes to f32 and
    ``log1p(exp(-|logits|))`` stays in the compute dtype."""
    logits = dlrm_apply(qa, params, batch["dense"], batch["sparse"])
    y = batch["labels"]
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits)) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank AUC, ties ordered by ``np.argsort`` as the reference orders them."""
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    n1, n0 = labels.sum(), (1 - labels).sum()
    return float((ranks[labels == 1].sum() - n1 * (n1 + 1) / 2) / max(n1 * n0, 1))


def train_dlrm(policy_name: str, *, steps: int = 300, seed: int = 0,
               lr: float = 0.1, record_cancellation: bool = False,
               lr_decay: bool = False, device=None, init_params=None):
    """Paper's DLRM on the synthetic click model → (losses, auc, extras,
    us_per_step). ``extras`` are the fractions of the embedding tables'
    non-zero gradient entries whose weight the update left unchanged,
    every 10 steps (``record_cancellation``). The time per step is the
    host's clock over every step, each ending in the read of its loss."""
    dev = resolve_device(device)
    policy = get_policy(policy_name)
    qa = QArith(policy)
    if init_params is None:     # the reference's weights, on every device
        init_params = dlrm_init(jrandom.PRNGKey(seed), DLRM_KAGGLE_SMALL, device=dev)
    params = init_params_for_policy(init_params, policy)
    opt = sgd(policy, momentum=0.0)
    state = opt.init(params)
    cancel_frac = []
    losses = []
    gen = dlrm_batches(DLRM_KAGGLE_SMALL, 128, seed=seed + 1, device=dev)
    val = [next(gen) for _ in range(4)]
    _sync()
    t0 = time.perf_counter()
    for i, batch in enumerate(gen):
        if i >= steps:
            break
        leaves = [w.detach().requires_grad_(True) for w in tree_leaves(params)]
        with torch.enable_grad():
            loss = dlrm_loss(qa, tree_unflatten(params, leaves), batch)
            grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
        del leaves
        lr_i = lr
        if lr_decay:    # in f32, as the reference computes it
            lr_i = float(np.float32(lr) * (np.float32(1.0)
                                           - np.float32(i) / np.float32(steps)))
        record = record_cancellation and i % 10 == 0
        if record:      # the update writes the tables in place: keep a copy
            old_t = params["tables"].to(torch.float32, copy=True)
        params, state = opt.update(grads, state, params, step=i, key=StepKey(seed, i),
                                   lr=lr_i)
        if record:
            new_t = params["tables"].to(torch.float32)
            nz = grads["tables"].to(torch.float32) != 0
            cancelled = nz & (old_t == new_t)
            cancel_frac.append(float(cancelled.sum() / torch.clamp(nz.sum(), min=1)))
            del old_t, new_t
        losses.append(float(loss.detach()))
    dt_us = (time.perf_counter() - t0) / max(len(losses), 1) * 1e6
    # AUC on held-out batches
    with torch.no_grad():
        scores = [dlrm_apply(qa, params, b["dense"], b["sparse"]).to(torch.float32).cpu()
                  for b in val]
    s = torch.cat(scores).numpy()
    y = torch.cat([b["labels"].cpu() for b in val]).numpy()
    return losses, auc(s, y), cancel_frac, dt_us
