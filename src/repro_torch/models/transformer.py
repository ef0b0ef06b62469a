"""Decoder-only LM over the dense / GQA / MoE / SSM / hybrid families and
the vlm backbone (embeddings in, M-RoPE): the full-sequence forward
(training) and the decode step (port of ``repro.models.transformer``).

Parameters keep the reference's stacked layout. A uniform stack is one
group of one block kind (``attn``, ``moe`` or ``mamba``) repeated
``n_layers`` times; a ``block_pattern`` config (recurrentgemma: ``rec,
rec, local_attn``) stacks whole pattern groups and keeps the remainder
unstacked (:func:`_layer_plan`). Every leaf under ``params["layers"]
["b<i>"]`` carries a leading group dim; ``params["rem"]["b<i>"]`` holds the
remainder's blocks. Both paths walk the groups with a Python loop where
the reference scans them. The forward splits each stacked leaf with one
``unbind``, whose backward stacks the per-group gradients; with
``remat=True`` each group runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of the scan body).

The decode cache mirrors the plan: attention blocks hold ``(k, v, k_pos)``
with k/v ``(G,N,Sc,Hkv,D)`` and k_pos ``(G,N,Sc)`` i32 (a window-sized
ring for sliding-window and local attention), or — paged, for
full-context layers — ``{"k_pages", "v_pages", "pos_pages"}``; Mamba and
RG-LRU blocks hold ``{"conv", "h"}`` (conv in the cache dtype, h f32),
per slot even when paged. Attention caches are written in place; a
recurrent step returns new state tensors, which
:func:`repro_torch.serve.cache.keep_active` selects into the cache per
lane.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.qarith import QArith
from repro_torch.dist import axes
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM

__all__ = ["init_lm", "init_cache", "forward", "decode_step", "embed_rows", "lm_logits"]

PyTree = Any

# block kinds whose decode state is recurrent ({"conv", "h"})
RECURRENT_KINDS = ("mamba", "rec")


def _block_kind(cfg, layer_idx: int) -> str:
    if cfg.family == "ssm":
        return "mamba"
    if cfg.block_pattern:
        return cfg.block_pattern[layer_idx % len(cfg.block_pattern)]
    return "moe" if cfg.n_experts else "attn"


def block_init(gen: torch.Generator, cfg, kind: str, dtype=torch.float32) -> PyTree:
    dev = gen.device
    if kind == "mamba":
        return {"ln1": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
                "mixer": SSM.mamba_init(gen, cfg, dtype)}
    p = {"ln1": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
         "ln2": L.norm_init(cfg.norm, cfg.d_model, dtype, dev)}
    if kind == "rec":
        p["mixer"] = RG.rglru_init(gen, cfg, dtype)
    else:                                  # attn / local_attn / moe
        p["mixer"] = L.attention_init(gen, cfg, dtype)
    if kind == "moe":
        p["ffn"] = M.moe_init(gen, cfg, dtype)
    else:
        p["ffn"] = M.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def _one_token(x, what: str):
    if x.shape[1] != 1:
        raise ValueError(f"{what} decode is strictly one token per step; chunked "
                         "prefill requires an attention-only block pattern")


def block_apply(qa: QArith, cfg, kind: str, p, x, *, positions, cache=None,
                attn_chunk: int = 1024, block_table=None, mrope_positions=None):
    """One block; returns (x, cache) — None for the full-sequence path, the
    attention cache updated in place, or a recurrent block's new state.
    ``mrope_positions`` ((3,B,S)) drive an attention block's M-RoPE."""
    h = L.norm_apply(qa, cfg.norm, p["ln1"], x)
    if kind == "mamba":
        if cache is None:
            return qa.add(x, SSM.mamba_apply(qa, p["mixer"], h, cfg)), None
        _one_token(x, "mamba")
        y, cache = SSM.mamba_decode_step(qa, p["mixer"], h, cfg, cache)
        return qa.add(x, y), cache
    if kind == "rec":
        if cache is None:
            y = RG.rglru_apply(qa, p["mixer"], h, cfg)
        else:
            _one_token(x, "recurrent")
            y, cache = RG.rglru_decode_step(qa, p["mixer"], h, cfg, cache)
    else:
        window = cfg.local_attn_window if kind == "local_attn" else cfg.swa_window
        y, cache = L.attention_apply(qa, p["mixer"], h, cfg, positions=positions,
                                     cache=cache, window=window, chunk=attn_chunk,
                                     block_table=block_table,
                                     mrope_positions=mrope_positions)
    x = qa.add(x, y)
    h = L.norm_apply(qa, cfg.norm, p["ln2"], x)
    if kind == "moe":
        y = M.moe_apply(qa, p["ffn"], h, cfg)
    else:
        y = M.mlp_apply(qa, p["ffn"], h, cfg.act_fn)
    return qa.add(x, y), cache


def _layer_plan(cfg) -> tuple[list[str], int, list[str]]:
    """(block kinds of one stacked group, number of groups, remainder kinds):
    a uniform stack is ``n_layers`` groups of one block; a hybrid pattern
    stacks whole pattern groups and leaves the remainder unstacked."""
    if cfg.block_pattern:
        plen = len(cfg.block_pattern)
        return (list(cfg.block_pattern), cfg.n_layers // plen,
                [cfg.block_pattern[i] for i in range(cfg.n_layers % plen)])
    return [_block_kind(cfg, 0)], cfg.n_layers, []


def _map(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(tree: PyTree, i: int) -> PyTree:
    """Group ``i`` of a stacked tree (dicts and cache tuples)."""
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


def stacked(make, n: int) -> PyTree:
    """``n`` trees from ``make()`` stacked leaf by leaf (a leading dim of
    ``n``), drawn one at a time into the preallocated stack, so building
    it never holds a second copy."""
    first = make()
    stack = _map(lambda t: t.new_empty((n, *t.shape)), first)
    _fill(stack, 0, first)
    del first
    for i in range(1, n):
        _fill(stack, i, make())
    return stack


def init_lm(cfg, gen: torch.Generator, dtype=torch.float32) -> PyTree:
    """Parameters on ``gen``'s device, drawn from ``gen``: the embedding,
    the final norm, an untied ``lm_head`` unless ``tie_embeddings``, the
    stacked groups (:func:`stacked`) and the remainder."""
    kinds, n_groups, rem = _layer_plan(cfg)
    params = {"embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dtype),
              "final_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, gen.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab, dtype=dtype)
    params["layers"] = stacked(
        lambda: {f"b{i}": block_init(gen, cfg, kind, dtype) for i, kind in enumerate(kinds)},
        n_groups)
    if rem:
        params["rem"] = {f"b{i}": block_init(gen, cfg, kind, dtype)
                         for i, kind in enumerate(rem)}
    return params


def _block_cache(cfg, kind: str, batch: int, max_len: int, dtype, page_size, n_rows,
                 device, kv_heads, d_inner, lru_width, lead=()):
    """One block's decode cache, with ``lead`` dims (the group dim) first."""
    def zeros(*shape, dt=dtype):
        return torch.zeros((*lead, *shape), dtype=dt, device=device)
    if kind == "mamba":
        return {"conv": zeros(batch, cfg.ssm_conv - 1, d_inner),
                "h": zeros(batch, d_inner, cfg.ssm_state, dt=torch.float32)}
    if kind == "rec":
        return {"conv": zeros(batch, cfg.ssm_conv - 1, lru_width),
                "h": zeros(batch, lru_width, dt=torch.float32)}
    window = cfg.local_attn_window if kind == "local_attn" else cfg.swa_window
    clen = min(max_len, window) if window else max_len
    hd, Hkv = cfg.head_dim, kv_heads
    if page_size is not None and clen == max_len:
        # full-context attention → the paged pool; ring layers stay
        # contiguous: their cache is already token-tight
        return {"k_pages": zeros(n_rows, page_size, Hkv, hd),
                "v_pages": zeros(n_rows, page_size, Hkv, hd),
                "pos_pages": torch.full((*lead, n_rows, page_size), -1, dtype=torch.int32,
                                        device=device)}
    return (zeros(batch, clen, Hkv, hd), zeros(batch, clen, Hkv, hd),
            torch.full((*lead, batch, clen), -1, dtype=torch.int32, device=device))


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               page_size=None, n_rows=None, device=None, kv_heads=None,
               d_inner=None, lru_width=None) -> PyTree:
    """Decode cache (reference ``transformer.py:146-190``): per stacked
    block a leaf with the group dim first, per remainder block one without.
    ``page_size``/``n_rows`` switch full-context attention layers to the
    paged pool of ``n_rows`` pages (all layers share one block table);
    ring-window and recurrent leaves keep the per-slot layout.
    ``kv_heads`` (default ``cfg.n_kv_heads``) is the kv heads this rank's
    attention kernels read: a model axis's share under tensor parallelism
    (``layers.head_plan``); ``d_inner`` (default ``cfg.d_inner``) and
    ``lru_width`` (default ``cfg.lru_width or cfg.d_model``) likewise the
    Mamba and RG-LRU channels of this rank's blocks (the reference's
    ``cache_specs`` split ``conv`` and ``h`` on that axis)."""
    if (page_size is None) != (n_rows is None):
        raise ValueError("page_size and n_rows must be given together")
    kv_heads = cfg.n_kv_heads if kv_heads is None else kv_heads
    d_inner = cfg.d_inner if d_inner is None else d_inner
    lru_width = (cfg.lru_width or cfg.d_model) if lru_width is None else lru_width
    kinds, n_groups, rem = _layer_plan(cfg)
    shared = (batch, max_len, dtype, page_size, n_rows, device, kv_heads, d_inner, lru_width)
    cache = {"layers": {f"b{i}": _block_cache(cfg, kind, *shared, (n_groups,))
                        for i, kind in enumerate(kinds)}}
    if rem:
        cache["rem"] = {f"b{i}": _block_cache(cfg, kind, *shared)
                        for i, kind in enumerate(rem)}
    return cache


def embed_rows(cfg, params, ids):
    """The embedding rows of token ids, unrounded. Under a model axis the
    embedding holds this rank's vocab rows
    (:func:`repro_torch.dist.axes.embed_lookup`, whose gradient reaches
    this rank's rows), or, where the axis does not divide the vocabulary,
    the whole table (``param_specs`` replicates it): a plain lookup,
    whose gradient is already the whole one on every rank."""
    table = params["embed"]["embedding"]
    if axes.vocab_whole(cfg.vocab):
        return table[ids.long()]
    return axes.embed_lookup(table, ids)


def _embed_tokens(qa: QArith, cfg, params, tokens):
    """Token ids (B,S) int32/int64 → their embedding rows
    (:func:`embed_rows`); (B,S,D) float embeddings (the vlm frontend
    stub's patch and text embeddings) pass through. Both are rounded to
    the compute grid."""
    if tokens.dtype in (torch.int32, torch.int64):
        x = embed_rows(cfg, params, tokens)
    elif tokens.is_floating_point() and tokens.dim() == 3:
        x = tokens
    else:
        raise TypeError(f"tokens must be (B,S) int32/int64 ids or (B,S,D) float "
                        f"embeddings, got {tokens.dtype} {tuple(tokens.shape)}")
    x = qa.cast(x)
    if cfg.block_pattern:                  # the (recurrent)gemma convention
        x = qa.mul(x, torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32))
    return x


def lm_logits(qa: QArith, cfg, params, x, *, gather: bool = True):
    """f32 logits over the vocabulary of the final norm of ``x``. Under a
    model axis the tied embedding or the untied ``lm_head`` holds this
    rank's vocab columns (the final norm's output, their shared input,
    through ``axes.copy_to_model``): the ranks' logits gathered in rank
    order, or with ``gather=False`` this rank's columns (training's loss,
    ``axes.vocab_parallel_xent``). A head the axis leaves whole (it does
    not divide the vocabulary) gives every rank the whole logits, and the
    norm's output skips ``copy_to_model``: each rank's gradient is
    already the whole one, and summing it over the group would count it
    once per rank."""
    h = L.norm_apply(qa, cfg.norm, params["final_norm"], x)
    w = params["embed"]["embedding"].T if cfg.tie_embeddings else params["lm_head"]["kernel"]
    if axes.vocab_whole(cfg.vocab):
        return qa.matmul_f32out(h, w)
    out = qa.matmul_f32out(axes.copy_to_model(h), w)
    return axes.gather_logits(out) if gather else out


def _unstack(stack: PyTree, n: int) -> list[PyTree]:
    """Per-group views of the stacked tree, one ``unbind`` per leaf."""
    parts = _map(lambda t: t.unbind(0), stack)
    return [_map(lambda groups, i=i: groups[i], parts) for i in range(n)]


def forward(qa: QArith, params, cfg, tokens, *, positions=None, mrope_positions=None,
            remat: bool = True, attn_chunk: int = 1024, logits: bool = True):
    """Full-sequence forward. tokens: (B,S) int or (B,S,D) embeddings;
    ``mrope_positions`` (3,B,S) for M-RoPE. Returns logits (B,S,V) f32,
    or the final hidden state when ``logits=False``. Under a model axis
    (training) the logits are this rank's vocab columns (B,S,V/size).

    A remat group re-installs the model axis it was first run under: its
    recompute runs inside the backward, which autograd runs on a thread of
    its own on CUDA, where no axis is installed."""
    kinds, n_groups, rem = _layer_plan(cfg)
    B, Sq = tokens.shape[:2]
    if positions is None:
        positions = torch.arange(Sq, device=tokens.device)[None].expand(B, Sq)
    x = _embed_tokens(qa, cfg, params, tokens)
    axis = axes.current()

    def body(x, p_group):
        with axes.model_axis(axis):
            for i, kind in enumerate(kinds):
                x, _ = block_apply(qa, cfg, kind, p_group[f"b{i}"], x, positions=positions,
                                   attn_chunk=attn_chunk, mrope_positions=mrope_positions)
        return x

    for p in _unstack(params["layers"], n_groups):
        x = checkpoint(body, x, p, use_reentrant=False) if remat else body(x, p)
    for i, kind in enumerate(rem):
        x, _ = block_apply(qa, cfg, kind, params["rem"][f"b{i}"], x, positions=positions,
                           attn_chunk=attn_chunk, mrope_positions=mrope_positions)
    return lm_logits(qa, cfg, params, x, gather=False) if logits else x


def decode_step(qa: QArith, params, cfg, token, cache, cache_pos, *,
                mrope_positions=None, block_table=None, out_rows=None):
    """One decode step. token: (B,S) int or (B,S,D) embeddings, with
    ``mrope_positions`` (3,B,S) for M-RoPE; cache_pos: (B,) per-lane depths
    for S=1 or (B,S) per-token positions (chunked prefill, attention-only
    stacks); −1 marks a parked lane or a padding token, whose KV write
    changes nothing. ``block_table`` (B, n_blocks) i32 routes a paged
    cache. Returns ``(logits (B,S,V) f32, new_cache)``: attention leaves
    are the cache's own, updated in place; recurrent leaves are new tensors
    (stacked over the groups), for the caller to keep or select per lane.

    ``out_rows`` ((B,) int) keeps one token row per lane before the
    logits: logits are then (B,1,V). A chunk step reads only each lane's
    last real row, and the logits product then has the B rows of a
    single-token step (matmul rows depend on the row count, ROADMAP C6)."""
    kinds, n_groups, rem = _layer_plan(cfg)
    B, S = token.shape[:2]
    positions = cache_pos.reshape(B, S).to(torch.int32)
    x = _embed_tokens(qa, cfg, params, token)

    def run(kind, p, c, x):
        return block_apply(qa, cfg, kind, p, x, positions=positions, cache=c,
                           block_table=block_table, mrope_positions=mrope_positions)

    new_states = {f"b{i}": [] for i, kind in enumerate(kinds) if kind in RECURRENT_KINDS}
    for g in range(n_groups):
        for i, kind in enumerate(kinds):
            name = f"b{i}"
            x, c = run(kind, _layer(params["layers"][name], g),
                       _layer(cache["layers"][name], g), x)
            if name in new_states:
                new_states[name].append(c)
    new_cache = {"layers": {
        name: ({k: torch.stack([s[k] for s in new_states[name]]) for k in ("conv", "h")}
               if name in new_states else leaf)
        for name, leaf in cache["layers"].items()}}
    if rem:
        new_cache["rem"] = {}
        for i, kind in enumerate(rem):
            name = f"b{i}"
            x, new_cache["rem"][name] = run(kind, params["rem"][name], cache["rem"][name], x)
    if out_rows is not None:
        x = torch.gather(x, 1, out_rows.long()[:, None, None].expand(-1, 1, x.shape[-1]))
    return lm_logits(qa, cfg, params, x), new_cache
