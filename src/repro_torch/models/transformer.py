"""Dense decoder-only LM: the full-sequence forward (training) and the
decode step (port of ``repro.models.transformer``).

Parameters keep the reference's stacked layout — every leaf under
``params["layers"]["b0"]`` carries a leading layer dim L — and both paths
walk the stack with a Python loop where the reference scans it. The
forward splits each stacked leaf with one ``unbind``, whose backward
stacks the per-layer gradients into one stacked gradient; with
``remat=True`` each layer runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of the scan body), so only layer inputs
are kept for the backward. The decode cache mirrors the stack:
``cache["layers"]["b0"] = (k, v, k_pos)`` with k/v ``(L,N,Sc,Hkv,D)`` and
k_pos ``(L,N,Sc)`` i32, or — paged — ``{"k_pages", "v_pages",
"pos_pages"}`` with pages ``(L,R,P,Hkv,D)`` and positions ``(L,R,P)``.
Only the dense ``"attn"`` block is ported.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.qarith import QArith
from repro_torch.models import layers as L
from repro_torch.models import moe as M

__all__ = ["init_lm", "init_cache", "forward", "decode_step"]

PyTree = Any


def block_init(gen: torch.Generator, cfg, dtype=torch.float32) -> PyTree:
    return {"ln1": L.norm_init(cfg.norm, cfg.d_model, dtype, gen.device),
            "ln2": L.norm_init(cfg.norm, cfg.d_model, dtype, gen.device),
            "mixer": L.attention_init(gen, cfg, dtype),
            "ffn": M.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)}


def block_apply(qa: QArith, cfg, p, x, *, positions, cache=None,
                attn_chunk: int = 1024, block_table=None):
    """One dense attention block; returns (x, cache) — the decode cache
    updated in place, or None for the full-sequence path."""
    h = L.norm_apply(qa, cfg.norm, p["ln1"], x)
    y, cache = L.attention_apply(qa, p["mixer"], h, cfg, positions=positions,
                                 cache=cache, window=cfg.swa_window,
                                 chunk=attn_chunk, block_table=block_table)
    x = qa.add(x, y)
    h = L.norm_apply(qa, cfg.norm, p["ln2"], x)
    y = M.mlp_apply(qa, p["ffn"], h, cfg.act_fn)
    return qa.add(x, y), cache


def _map(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(tree: PyTree, i: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(t[i] for t in tree)
    return tree[i]


def _fill(stack: PyTree, i: int, block: PyTree) -> None:
    for k, v in block.items():
        if isinstance(v, dict):
            _fill(stack[k], i, v)
        else:
            stack[k][i] = v


def init_lm(cfg, gen: torch.Generator, dtype=torch.float32) -> PyTree:
    """Parameters on ``gen``'s device, drawn from ``gen``. Layers are
    drawn one at a time into the preallocated stack, so building the
    stack never holds a second copy of the weights."""
    params = {"embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dtype),
              "final_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, gen.device)}
    first = block_init(gen, cfg, dtype)
    stack = _map(lambda t: t.new_empty((cfg.n_layers, *t.shape)), first)
    _fill(stack, 0, first)
    for i in range(1, cfg.n_layers):
        _fill(stack, i, block_init(gen, cfg, dtype))
    params["layers"] = {"b0": stack}
    return params


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               page_size=None, n_rows=None, device=None) -> PyTree:
    """Decode cache: one ``max_len`` stripe per lane (a window-sized ring
    for sliding-window attention), or with ``page_size``/``n_rows`` the
    paged pool of ``n_rows`` pages of ``page_size`` cells for full-context
    layers (all layers share one block table; reference
    ``transformer.py:146-190``). Ring layers stay contiguous: their cache
    is already token-tight."""
    if (page_size is None) != (n_rows is None):
        raise ValueError("page_size and n_rows must be given together")
    window = cfg.swa_window
    clen = min(max_len, window) if window else max_len
    if page_size is not None and clen == max_len:
        shape = (cfg.n_layers, n_rows, page_size, cfg.n_kv_heads, cfg.head_dim)
        return {"layers": {"b0": {
            "k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device),
            "pos_pages": torch.full(shape[:3], -1, dtype=torch.int32, device=device)}}}
    shape = (cfg.n_layers, batch, clen, cfg.n_kv_heads, cfg.head_dim)
    return {"layers": {"b0": (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.full(shape[:3], -1, dtype=torch.int32, device=device))}}


def _embed_tokens(qa: QArith, params, tokens):
    return qa.cast(params["embed"]["embedding"][tokens.long()])


def _logits(qa: QArith, cfg, params, x):
    h = L.norm_apply(qa, cfg.norm, params["final_norm"], x)
    return qa.matmul_f32out(h, params["embed"]["embedding"].T)


def _unstack(stack: PyTree, n_layers: int) -> list[PyTree]:
    """Per-layer views of the stacked tree, one ``unbind`` per leaf."""
    parts = _map(lambda t: t.unbind(0), stack)
    return [_map(lambda layers, i=i: layers[i], parts) for i in range(n_layers)]


def forward(qa: QArith, params, cfg, tokens, *, positions=None, remat: bool = True,
            attn_chunk: int = 1024, logits: bool = True):
    """Full-sequence forward. tokens: (B,S) int. Returns logits (B,S,V) f32,
    or the final hidden state when ``logits=False``."""
    B, Sq = tokens.shape[:2]
    if positions is None:
        positions = torch.arange(Sq, device=tokens.device)[None].expand(B, Sq)
    x = _embed_tokens(qa, params, tokens)

    def body(x, p):
        return block_apply(qa, cfg, p, x, positions=positions, attn_chunk=attn_chunk)[0]

    for p in _unstack(params["layers"]["b0"], cfg.n_layers):
        x = checkpoint(body, x, p, use_reentrant=False) if remat else body(x, p)
    return _logits(qa, cfg, params, x) if logits else x


def decode_step(qa: QArith, params, cfg, token, cache, cache_pos, *,
                block_table=None, out_rows=None):
    """One decode step. token: (B,S) int; cache_pos: (B,) per-lane depths
    for S=1 or (B,S) per-token positions (chunked prefill); −1 marks a
    parked lane or a padding token, whose KV write changes nothing.
    ``block_table`` (B, n_blocks) i32 routes a paged cache. Returns
    ``(logits (B,S,V) f32, cache)``; the cache is updated in place.

    ``out_rows`` ((B,) int) keeps one token row per lane before the
    logits: logits are then (B,1,V). A chunk step reads only each lane's
    last real row, and the logits product then has the B rows of a
    single-token step (matmul rows depend on the row count, ROADMAP C6)."""
    B, S = token.shape
    positions = cache_pos.reshape(B, S).to(torch.int32)
    x = _embed_tokens(qa, params, token)
    stack, stack_cache = params["layers"]["b0"], cache["layers"]["b0"]
    for i in range(cfg.n_layers):
        x, _ = block_apply(qa, cfg, _layer(stack, i), x, positions=positions,
                           cache=_layer(stack_cache, i), block_table=block_table)
    if out_rows is not None:
        x = torch.gather(x, 1, out_rows.long()[:, None, None].expand(-1, 1, x.shape[-1]))
    return _logits(qa, cfg, params, x), cache
