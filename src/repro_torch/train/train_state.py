"""Training state + loss functions (port of ``repro.train.train_state``)."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

__all__ = ["TrainState", "softmax_xent", "make_train_state"]

PyTree = Any


class TrainState(NamedTuple):
    step: int                # Python int (the reference's i32 scalar)
    params: PyTree           # storage-format weights (master f32 if policy)
    opt_state: PyTree
    # error-feedback residuals of a stateful gradient transport; None
    # until the dist slice ports the transports
    wire_residuals: PyTree | None = None


def make_train_state(params: PyTree, optimizer, *, transport=None) -> TrainState:
    """Fresh state at step 0. Without a transport ``wire_residuals`` stays
    None; gradient transports are ported with the dist slice."""
    if transport is not None:
        raise ValueError("gradient transports are ported with the dist slice (ROADMAP A5)")
    return TrainState(0, params, optimizer.init(params), None)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, *, ignore: int = -1
                 ) -> torch.Tensor:
    """Mean next-token cross entropy. logits (B,S,V) f32, labels (B,S) int;
    positions labelled ``ignore`` do not count."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels != ignore).to(torch.float32)
    loss = (logz - gold) * mask
    return loss.sum() / torch.clamp(mask.sum(), min=1.0)
