"""DLRM (Naumov et al.) — the paper's recommendation workload (port of
``repro.models.dlrm``).

Bottom MLP over dense features + embedding tables for categorical features
+ pairwise dot-product interactions + top MLP → click logit. Embedding
tables are the paper's canonical high-cancellation tensors (Fig 9): sparse
rows receive rare, tiny updates, so nearest rounding cancels most of them.

The parameter tree is the reference's — ``bottom`` and ``top`` lists of
``{kernel, bias}``, ``tables`` one (T, V, E) leaf — so conversion and the
per-leaf SR streams line up leaf for leaf. The weights are the
reference's own draws: ``jax.random``'s bits from the same key, in numpy
(:mod:`repro_torch.core.jrandom`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import jrandom
from repro_torch.core.qarith import QArith
from repro_torch.models.layers import dense

__all__ = ["dlrm_init", "dlrm_apply", "DLRM_KAGGLE_SMALL"]

# Paper Table 9 scaled for synthetic runs: 13 dense, 26 sparse features.
DLRM_KAGGLE_SMALL = dict(
    n_dense=13, n_sparse=8, vocab_per_table=1000, emb_dim=16,
    bottom=(64, 32, 16), top=(64, 32, 1),
)


def _mlp_init(key, d_in, sizes):
    """The reference's ``_mlp_init`` in numpy f32: one split key per layer,
    a ``normal`` kernel scaled by 1/√d_in, a zero bias."""
    layers = []
    for k, d_out in zip(jrandom.split(key, len(sizes)), sizes):
        std = np.float32(1.0 / math.sqrt(d_in))
        layers.append({"kernel": jrandom.normal(k, (d_in, d_out)) * std,
                       "bias": np.zeros((d_out,), np.float32)})
        d_in = d_out
    return layers


def _mlp_apply(qa, layers, x, final_linear=True):
    for i, p in enumerate(layers):
        x = dense(qa, p, x)
        if i < len(layers) - 1 or not final_linear:
            x = qa.act(torch.relu, x)
    return x


def dlrm_init(key, cfg: dict, dtype=torch.float32, device=None):
    """The reference's ``dlrm_init(key, cfg)`` on ``device`` (CUDA unless
    ``"cpu"``): ``key`` is a :func:`repro_torch.core.jrandom.PRNGKey`, split
    as the reference splits it, so the weights are the reference's (its
    ``normal``'s last ulps aside, ROADMAP C20)."""
    dev = resolve_device(device)
    kb, kt, ke = jrandom.split(key, 3)
    n_tab, V, E = cfg["n_sparse"], cfg["vocab_per_table"], cfg["emb_dim"]
    emb = jrandom.normal(ke, (n_tab, V, E)) / np.float32(math.sqrt(E))
    n_feats = 1 + n_tab  # bottom output + each table
    n_inter = n_feats * (n_feats - 1) // 2
    tree = {
        "bottom": _mlp_init(kb, cfg["n_dense"], cfg["bottom"]),
        "tables": emb,
        "top": _mlp_init(kt, cfg["bottom"][-1] + n_inter, cfg["top"]),
    }

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dtype)
    return {"bottom": [{k: put(v) for k, v in p.items()} for p in tree["bottom"]],
            "tables": put(tree["tables"]),
            "top": [{k: put(v) for k, v in p.items()} for p in tree["top"]]}


def dlrm_apply(qa: QArith, params, dense_x, sparse_ids):
    """dense_x: (B, n_dense) f32; sparse_ids: (B, n_tab) int → logits (B,)."""
    B, n_tab = sparse_ids.shape
    bot = _mlp_apply(qa, params["bottom"], qa.cast(dense_x),
                     final_linear=False)                     # (B, E)
    tabs = params["tables"]                                  # (T, V, E)
    tab = torch.arange(n_tab, device=tabs.device)
    embs = tabs[tab[None, :], sparse_ids.long()]             # (B, T, E)
    feats = torch.cat([bot[:, None, :], qa.cast(embs)], dim=1)  # (B, F, E)
    inter = qa.einsum("bfe,bge->bfg", feats, feats)
    F = feats.shape[1]
    iu, ju = torch.triu_indices(F, F, 1, device=feats.device)
    flat = inter[:, iu, ju]                                  # (B, F(F-1)/2)
    top_in = torch.cat([bot, flat], dim=-1)
    return _mlp_apply(qa, params["top"], top_in)[:, 0]
