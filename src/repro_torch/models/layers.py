"""Quantized layers: dense, embedding, norms, RoPE, GQA decode attention
(port of ``repro.models.layers``, the parts the serving slice runs).

All contractions go through :class:`repro_torch.core.qarith.QArith` —
16-bit inputs, f32 accumulation, one output rounding. Attention is one
fused op: f32 internals, output rounded once. Public functions keep the
reference's layouts: dense kernels ``(d_in, d_out)``, q ``(B,S,H,D)``,
caches ``(N,Sc,Hkv,D)`` plus an i32 ``(N,Sc)`` position map (−1 = empty).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.qarith import QArith
from repro_torch.kernels import dispatch
from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                  fused_decode_attention)

__all__ = ["dense_init", "dense", "embed_init", "norm_init", "norm_apply",
           "rope", "decode_attention", "attention_init", "attention_apply"]


# ---------------------------------------------------------------------------
# Param init (seeded torch.Generator; the draws differ from jax.random's)
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32):
    p = {"kernel": _normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(qa: QArith, p, x):
    y = qa.einsum("...d,df->...f", x, p["kernel"])
    if "bias" in p:
        y = qa.add(y, p["bias"])
    return y


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype=torch.float32):
    return {"embedding": _normal(gen, (vocab, d_model), 1.0 / math.sqrt(d_model), dtype)}


def norm_init(kind: str, d: int, dtype=torch.float32, device=None):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(qa: QArith, kind: str, p, x):
    if kind == "ln":
        return qa.layernorm(x, p["scale"], p["bias"])
    return qa.rmsnorm(x, p["scale"])


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def _rope_angles(positions, head_dim: int, theta: float):
    # positions: (..., S) int → (..., S, head_dim/2) angles, f32
    freqs = torch.exp(-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                    device=positions.device)
                      / head_dim * math.log(theta))
    return positions[..., None].to(torch.float32) * freqs


def rope(x, positions, theta: float = 10000.0):
    """Standard RoPE. x: (B,S,H,D); positions: (B,S) or (S,)."""
    d = x.shape[-1]
    ang = _rope_angles(positions, d, theta)               # (B,S,D/2)
    cos = torch.cos(ang)[..., None, :]                    # (B,S,1,D/2)
    sin = torch.sin(ang)[..., None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def decode_attention(qa: QArith, q, k_cache, v_cache, k_pos, *, q_pos,
                     window=None, softcap=None):
    """Attention of one query token per lane against a KV cache.

    q: (B,1,Hq,D); caches: (B,Sc,Hkv,D); k_pos: (B,Sc) i32 (−1 ⇒ empty
    cell); q_pos: (B,) i32 (−1 ⇒ parked lane). Inside a
    :func:`repro_torch.kernels.dispatch.fused_decode` context it runs the
    fused decode kernel; otherwise its plain PyTorch version. Both give
    the same op order and one output rounding. A multi-token chunk
    (chunked prefill) arrives with the paged-serving slice.
    """
    B, S = q.shape[:2]
    if S != 1:
        raise ValueError(f"decode attention takes one token per lane, got {S}; "
                         "chunked prefill is ported with the paged-serving slice")
    q_pos = q_pos.reshape(B)
    attend = (fused_decode_attention if dispatch.fused_decode_enabled()
              else decode_attention_ref)
    out = attend(q, k_cache, v_cache, k_pos, q_pos, window=window,
                 softcap=softcap, p_dtype=qa.dtype)
    return qa.cast(out)


def attention_init(gen: torch.Generator, cfg, dtype=torch.float32):
    hd = cfg.head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, bias=cfg.qkv_bias, dtype=dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, dtype=dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, dtype=dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype=dtype),
    }


def attention_apply(qa: QArith, p, x, cfg, *, positions, cache, window=None):
    """One decode token per lane against the contiguous per-lane cache.

    x: (B,1,Dm); positions: (B,1) per-lane depths, −1 for a parked lane;
    cache: ``(k_cache, v_cache, k_pos)`` for this layer. The lane's K/V
    land at cell ``pos % Sc`` **in place** (the reference returns a new
    cache from a donated buffer). A parked lane's write is routed to cell
    0 carrying that cell's current contents, so it changes nothing — the
    reference drops it as out of range. Returns ``(out, cache)``.
    """
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"the contiguous decode path takes one token per "
                         f"lane, got {S}; chunked prefill is ported with the "
                         "paged-serving slice")
    hd = cfg.head_dim
    q = dense(qa, p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = dense(qa, p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = dense(qa, p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    k_cache, v_cache, k_pos = cache
    Sc = k_cache.shape[1]
    tpos = positions.reshape(B).to(torch.int32)
    live = tpos >= 0
    lane = torch.arange(B, device=x.device)
    slot = torch.where(live, tpos % Sc, 0)
    keep = live[:, None, None]
    k_cache[lane, slot] = torch.where(keep, k[:, 0].to(k_cache.dtype), k_cache[lane, slot])
    v_cache[lane, slot] = torch.where(keep, v[:, 0].to(v_cache.dtype), v_cache[lane, slot])
    k_pos[lane, slot] = torch.where(live, tpos, k_pos[lane, slot])

    out = decode_attention(qa, q, k_cache, v_cache, k_pos, q_pos=tpos,
                           window=window, softcap=cfg.attn_logit_softcap)
    out = out.reshape(B, S, cfg.n_heads * hd)
    return dense(qa, p["wo"], out), cache
