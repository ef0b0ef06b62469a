"""DLRM (Naumov et al.) — the paper's recommendation workload (port of
``repro.models.dlrm``).

Bottom MLP over dense features + embedding tables for categorical features
+ pairwise dot-product interactions + top MLP → click logit. Embedding
tables are the paper's canonical high-cancellation tensors (Fig 9): sparse
rows receive rare, tiny updates, so nearest rounding cancels most of them.

The parameter tree is the reference's — ``bottom`` and ``top`` lists of
``{kernel, bias}``, ``tables`` one (T, V, E) leaf — so conversion and the
per-leaf SR streams line up leaf for leaf.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.qarith import QArith
from repro_torch.models.layers import dense, dense_init

__all__ = ["dlrm_init", "dlrm_apply", "DLRM_KAGGLE_SMALL"]

# Paper Table 9 scaled for synthetic runs: 13 dense, 26 sparse features.
DLRM_KAGGLE_SMALL = dict(
    n_dense=13, n_sparse=8, vocab_per_table=1000, emb_dim=16,
    bottom=(64, 32, 16), top=(64, 32, 1),
)


def _mlp_init(gen, d_in, sizes, dtype):
    layers = []
    for d_out in sizes:
        layers.append(dense_init(gen, d_in, d_out, bias=True, dtype=dtype))
        d_in = d_out
    return layers


def _mlp_apply(qa, layers, x, final_linear=True):
    for i, p in enumerate(layers):
        x = dense(qa, p, x)
        if i < len(layers) - 1 or not final_linear:
            x = qa.act(torch.relu, x)
    return x


def dlrm_init(gen: torch.Generator, cfg: dict, dtype=torch.float32):
    """Parameters drawn from ``gen`` (a ``torch.Generator``, on its device):
    the reference's shapes and scales, the port's own draws."""
    n_tab, V, E = cfg["n_sparse"], cfg["vocab_per_table"], cfg["emb_dim"]
    bottom = _mlp_init(gen, cfg["n_dense"], cfg["bottom"], dtype)
    emb = (torch.randn((n_tab, V, E), generator=gen, device=gen.device,
                       dtype=torch.float32) / math.sqrt(E)).to(dtype)
    n_feats = 1 + n_tab  # bottom output + each table
    n_inter = n_feats * (n_feats - 1) // 2
    return {
        "bottom": bottom,
        "tables": emb,
        "top": _mlp_init(gen, cfg["bottom"][-1] + n_inter, cfg["top"], dtype),
    }


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
