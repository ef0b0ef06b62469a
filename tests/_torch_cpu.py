"""Helpers shared by the port's paper tests (DLRM, least squares, the
sections), which hold ``repro_torch`` against the reference on the CPU."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors: beside the other
    test workers, more threads oversubscribe the cores and run ~50× slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_torch(a) -> torch.Tensor:
    """A reference array as a CPU tensor of the same values: bf16 by its
    bits, u32 widened to int64 (torch has no u32 arithmetic)."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(a.copy())
