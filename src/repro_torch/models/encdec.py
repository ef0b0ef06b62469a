"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_src, D). Encoder: a bidirectional
self-attention stack on sinusoidal positions. Decoder: causal
self-attention, cross-attention over the encoder output, sinusoidal
positions. Parameters keep the reference's stacked layout and key names:
``enc_layers`` (``ln1``, ``attn``, ``ln2``, ``mlp``) and ``dec_layers``
(``ln1``, ``self_attn``, ``ln_x``, ``cross_attn``, ``ln2``, ``mlp``), each
leaf with a leading layer dim, plus ``embed``, ``enc_norm`` and
``final_norm``.

Decoding is lock-step, as in the reference: :func:`init_decode_cache`
encodes once and holds the self-attention KV ring ``(k, v, k_pos)``
(``(L,B,Sc,Hkv,D)``, written in place), the per-layer cross K/V
``(L,B,S_src,Hkv,D)`` in the cache dtype and their key positions
``cross_pos`` ((B,S_src) int32, ``arange``), built once and contiguous, as
the decode kernel takes them. A step's cross-attention is a decode
attention with the query at position S_src, which sees every key.

Under a model axis (:mod:`repro_torch.dist.axes`) both stacks are
tensor-parallel as the decoder-only families are: the self-attention
blocks through ``layers.attention_apply``, the MLPs through
``moe.mlp_apply``, the cross-attention on this rank's heads
(``layers.head_plan``: its q from ``ln_x``'s output, its k and v from the
encoder output, each input through ``copy_to_model`` at every use, and a
row-parallel ``wo``); the caches hold this rank's kv heads, as the
reference's ``cache_specs`` shard them. The embedding and the tied head
share the decoder-only path (``transformer.embed_rows``,
``transformer.lm_logits``): vocab-parallel where the axis divides the
vocabulary, whole on every rank otherwise (whisper-base's 51865).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.qarith import QArith
from repro_torch.dist import axes
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

__all__ = ["init_encdec", "encode", "decoder_forward", "init_decode_cache",
           "encdec_decode_step", "sinusoidal", "sinusoidal_at"]


def _inv_freq(d: int, device) -> torch.Tensor:
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    return torch.pow(10000.0, dim / torch.tensor(float(d), device=device))


def sinusoidal(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) f32: sin of every position's angles, then cos."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    ang = pos / _inv_freq(d, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """The sinusoidal rows of integer positions ``pos`` (any shape) →
    (*pos.shape, d) f32."""
    ang = pos.to(torch.float32)[..., None] / _inv_freq(d, pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_block_init(gen: torch.Generator, cfg, dtype):
    dev = gen.device
    return {"ln1": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
            "attn": L.attention_init(gen, cfg, dtype),
            "ln2": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
            "mlp": M.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)}


def _dec_block_init(gen: torch.Generator, cfg, dtype):
    dev = gen.device
    return {"ln1": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
            "self_attn": L.attention_init(gen, cfg, dtype),
            "ln_x": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
            "cross_attn": L.attention_init(gen, cfg, dtype),
            "ln2": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
            "mlp": M.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)}


def init_encdec(cfg, gen: torch.Generator, dtype=torch.float32):
    """Parameters on ``gen``'s device, drawn from ``gen`` (the port's own
    draws), in the reference's tree."""
    dev = gen.device
    return {"enc_layers": T.stacked(lambda: _enc_block_init(gen, cfg, dtype),
                                    cfg.n_enc_layers),
            "dec_layers": T.stacked(lambda: _dec_block_init(gen, cfg, dtype), cfg.n_layers),
            "embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dtype),
            "enc_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
            "final_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, dev)}


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def encode(qa: QArith, params, cfg, src_embeds, *, remat: bool = True,
           attn_chunk: int = 1024):
    """src_embeds: (B,S_src,D) frame embeddings → the encoder output
    (B,S_src,D) in the compute dtype. Flash attention takes key lengths
    that are a multiple of ``min(attn_chunk, S_src)``, as the reference's
    does (1500 frames: a chunk of 1500, 750 or 500)."""
    B, S, _ = src_embeds.shape
    x = qa.cast(src_embeds + sinusoidal(S, cfg.d_model, src_embeds.device)[None])
    positions = _positions(B, S, x.device)
    axis = axes.current()

    def body(x, p):
        # a remat recompute runs on autograd's thread: re-install the axis
        with axes.model_axis(axis):
            h = L.norm_apply(qa, cfg.norm, p["ln1"], x)
            y, _ = L.attention_apply(qa, p["attn"], h, cfg, positions=positions,
                                     causal=False, chunk=attn_chunk)
            x = qa.add(x, y)
            h = L.norm_apply(qa, cfg.norm, p["ln2"], x)
            return qa.add(x, M.mlp_apply(qa, p["mlp"], h, cfg.act_fn))

    for p in T._unstack(params["enc_layers"], cfg.n_enc_layers):
        x = checkpoint(body, x, p, use_reentrant=False) if remat else body(x, p)
    return L.norm_apply(qa, cfg.norm, params["enc_norm"], x)


def _cross_kv(qa: QArith, cfg, p, enc_out):
    """The cross-attention's k and v of this rank's kv heads
    (B,S_src,Hkv_local,hd)."""
    return L.local_kv(qa, p["cross_attn"]["wk"], p["cross_attn"]["wv"],
                      axes.copy_to_model(enc_out), L.head_plan(cfg), cfg.head_dim)


def _dec_block(qa: QArith, cfg, p, x, enc_out, positions, *, self_cache=None,
               cross_kv=None, cross_pos=None, attn_chunk: int = 1024):
    """One decoder block. Teacher-forced (``enc_out``): flash cross-attention
    over the whole encoder output. Decoding (``self_cache``, ``cross_kv``,
    ``cross_pos``): one token per lane against the self-attention ring and
    the cached cross K/V, both through the decode attention."""
    h = L.norm_apply(qa, cfg.norm, p["ln1"], x)
    y, _ = L.attention_apply(qa, p["self_attn"], h, cfg, positions=positions, causal=True,
                             cache=self_cache, chunk=attn_chunk)
    x = qa.add(x, y)
    h = L.norm_apply(qa, cfg.norm, p["ln_x"], x)
    B = h.shape[0]
    plan = L.head_plan(cfg)
    q = L.local_q(qa, p["cross_attn"]["wq"], axes.copy_to_model(h), plan, cfg.head_dim)
    if cross_kv is not None:
        k, v = cross_kv
        q_pos = torch.full((B,), k.shape[1], dtype=torch.int32, device=x.device)
        att = L.decode_attention(qa, q, k, v, cross_pos, q_pos=q_pos)
    else:
        k, v = _cross_kv(qa, cfg, p, enc_out)
        att = L.flash_attention(qa, q, k, v, causal=False, chunk=attn_chunk)
    x = qa.add(x, L.attention_out(qa, p["cross_attn"]["wo"], att, plan))
    h = L.norm_apply(qa, cfg.norm, p["ln2"], x)
    return qa.add(x, M.mlp_apply(qa, p["mlp"], h, cfg.act_fn))


def decoder_forward(qa: QArith, params, cfg, tokens, enc_out, *, remat: bool = True,
                    attn_chunk: int = 1024):
    """Teacher-forced decoder pass over tokens (B,S) → f32 logits (B,S,V);
    under a model axis (training) this rank's vocab columns where the axis
    divides the vocabulary (``transformer.lm_logits``)."""
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = qa.cast(T.embed_rows(cfg, params, tokens)
                + sinusoidal(S, cfg.d_model, tokens.device)[None])

    axis = axes.current()

    def body(x, p, enc_out):
        with axes.model_axis(axis):
            return _dec_block(qa, cfg, p, x, enc_out, positions, attn_chunk=attn_chunk)

    for p in T._unstack(params["dec_layers"], cfg.n_layers):
        x = (checkpoint(body, x, p, enc_out, use_reentrant=False) if remat
             else body(x, p, enc_out))
    return T.lm_logits(qa, cfg, params, x, gather=False)


def init_decode_cache(cfg, params, qa: QArith, enc_out, batch: int, max_len: int,
                      dtype=torch.bfloat16):
    """The lock-step decode cache of ``batch`` lanes: the self-attention
    ring ``self`` = (k, v, k_pos) of ``max_len`` cells (positions −1:
    empty), the per-layer cross K/V ``cross`` = (k, v) of the encoder
    output in ``dtype``, and ``cross_pos``, their (batch, S_src) int32 key
    positions. Under a model axis both hold this rank's kv heads."""
    hd, Hkv, n = cfg.head_dim, len(L.head_plan(cfg).kv_index), cfg.n_layers
    dev = enc_out.device
    S_src = enc_out.shape[1]
    selfkv = (torch.zeros((n, batch, max_len, Hkv, hd), dtype=dtype, device=dev),
              torch.zeros((n, batch, max_len, Hkv, hd), dtype=dtype, device=dev),
              torch.full((n, batch, max_len), -1, dtype=torch.int32, device=dev))
    k = torch.empty((n, batch, S_src, Hkv, hd), dtype=dtype, device=dev)
    v = torch.empty_like(k)
    for i in range(n):
        k[i], v[i] = _cross_kv(qa, cfg, T._layer(params["dec_layers"], i), enc_out)
    pos = _positions(batch, S_src, dev).to(torch.int32).contiguous()
    return {"self": selfkv, "cross": (k, v), "cross_pos": pos}


def encdec_decode_step(qa: QArith, params, cfg, token, cache, cache_pos):
    """One decoder token per lane. token: (B,1) int; cache_pos: a scalar
    (lock-step) or (B,) per-lane positions. The self-attention ring is
    written in place. Returns ``(logits (B,1,V) f32, cache)``."""
    B, S = token.shape
    if S != 1:
        raise ValueError(f"the encoder-decoder decodes one token per step, got {S}")
    positions = torch.as_tensor(cache_pos, device=token.device).to(torch.int32)
    positions = positions.reshape(-1, 1).expand(B, 1)
    x = qa.cast(T.embed_rows(cfg, params, token) + sinusoidal_at(positions, cfg.d_model))
    k_cross, v_cross = cache["cross"]
    for i in range(cfg.n_layers):
        x = _dec_block(qa, cfg, T._layer(params["dec_layers"], i), x, None, positions,
                       self_cache=T._layer(cache["self"], i),
                       cross_kv=(k_cross[i], v_cross[i]), cross_pos=cache["cross_pos"])
    return T.lm_logits(qa, cfg, params, x), cache
