"""Training state + loss functions (port of ``repro.train.train_state``)."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.dist import axes

__all__ = ["TrainState", "softmax_xent", "make_train_state"]

PyTree = Any


class TrainState(NamedTuple):
    step: int                # Python int (the reference's i32 scalar)
    params: PyTree           # storage-format weights (master f32 if policy)
    opt_state: PyTree
    # Error-feedback residuals of a stateful gradient transport
    # (repro_torch.dist.transport.CompressedWire): this rank's f32 row,
    # shape (1, *param_shape), of the reference's (wire_replicas,
    # *param_shape) buffer per parameter leaf. None under stateless
    # transports: a None subtree contributes no leaves, so checkpoints
    # written without residuals restore unchanged.
    wire_residuals: PyTree | None = None


def make_train_state(params: PyTree, optimizer, *, transport=None) -> TrainState:
    """Fresh state at step 0. ``transport`` (a
    :class:`repro_torch.dist.transport.GradientTransport`) initializes its
    error-feedback residuals into the state; omit it (or pass a stateless
    transport) and ``wire_residuals`` stays None."""
    residuals = transport.init_residuals(params) if transport is not None else None
    return TrainState(0, params, optimizer.init(params), residuals)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, *, ignore: int = -1,
                 vocab: int | None = None) -> torch.Tensor:
    """Mean next-token cross entropy. logits (B,S,V) f32, labels (B,S) int;
    positions labelled ``ignore`` do not count. Under a model axis the
    logits are this rank's vocab columns and the loss is
    :func:`repro_torch.dist.axes.vocab_parallel_xent` (the same function
    of the gathered logits), unless ``vocab``, the model's vocabulary
    size, is whole on every rank (:func:`axes.vocab_whole`). Without
    ``vocab`` the logits under an axis are taken as vocab columns."""
    if axes.current() is not None and (vocab is None or not axes.vocab_whole(vocab)):
        return axes.vocab_parallel_xent(logits, labels, ignore=ignore)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels != ignore).to(torch.float32)
    loss = (logz - gold) * mask
    return loss.sum() / torch.clamp(mask.sum(), min=1.0)
