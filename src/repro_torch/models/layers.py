"""Quantized layers: dense, embedding, norms, RoPE and M-RoPE, GQA
attention — the full-sequence flash path (training; causal, or
bidirectional for an encoder) and decode against the contiguous or the
paged KV pool, one token or a prefill chunk per lane (serving) (port of
``repro.models.layers``).

All contractions go through :class:`repro_torch.core.qarith.QArith` —
16-bit inputs, f32 accumulation, one output rounding. Attention is one
fused op: f32 internals, output rounded once. Public functions keep the
reference's layouts: dense kernels ``(d_in, d_out)``, q ``(B,S,H,D)``,
caches ``(N,Sc,Hkv,D)`` plus an i32 ``(N,Sc)`` position map (−1 = empty),
page pools ``(R,P,Hkv,D)`` plus ``(R,P)`` positions and a ``(N,n_blocks)``
block table.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.qarith import QArith, f32_product, on_tensor_cores
from repro_torch.dist import axes
from repro_torch.kernels import dispatch
from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                  fused_decode_attention,
                                                  fused_paged_decode_attention)
from repro_torch.kernels.qmatmul import qmatmul, qmatmul_f32
from repro_torch.kernels.row_mean_sq import row_mean_sq

__all__ = ["dense_init", "dense", "project", "project_f32", "project_row_parallel",
           "f32_rows_product", "embed_init", "norm_init", "norm_apply", "rope", "mrope", "flash_attention", "decode_attention",
           "attention_as_lanes", "paged_attention_as_lanes", "attention_init",
           "HeadPlan", "head_plan", "local_q", "local_kv", "attention_out",
           "attention_apply", "copy_page_rows"]


def _kernel_route(*tensors: torch.Tensor) -> bool:
    """Whether an op of the serve step runs on its row-independent kernel:
    inside :func:`repro_torch.kernels.dispatch.fused_decode`, on CUDA.
    On the card every such op gives a token row the same bits whatever
    the number of rows of the step (ROADMAP C10); on the CPU the ops stay
    the reference's own arithmetic."""
    return dispatch.fused_decode_enabled() and all(t.device.type == "cuda" for t in tensors)


def copy_page_rows(pages, dst, src, pdim: int = 0):
    """Physical page copy in place: ``pages[dst[j]] = pages[src[j]]``.

    The copy-on-write primitive of the prefix cache
    (:mod:`repro_torch.serve.paged`): before a lane's first write into a
    page it shares with the prefix index or another lane, the engine
    remaps that block to a private page and the serve step copies the row
    here — K rows, never the whole pool. All sources are read before any
    destination is written, as in the reference. ``dst``/``src`` are (K,)
    integer tensors of a static width, as the reference's: entries with
    ``dst`` ≥ the number of rows R are padding. The reference's scatter
    drops them; a torch scatter would fault on them, so they are remapped
    on the device (no host sync) to a self-copy of the null row R−1, which
    no real copy writes. ``pdim`` is the page-row dim: 0 for a bare paged
    leaf, 1 under the stacked layer dim.

    Applies identically to ``k_pages``/``v_pages`` *and* ``pos_pages``:
    the private copy must carry the source positions, or the copied KV
    cells would mask away as empty.
    """
    if pdim not in (0, 1):
        raise ValueError(f"page dim {pdim}: pools carry pages at dim 0 or 1")
    rows = pages.shape[pdim]
    real = dst < rows
    dst = torch.where(real, dst, rows - 1).long()
    src = torch.where(real, src, rows - 1).long()
    if pdim == 0:
        pages[dst] = pages[src]
    else:
        pages[:, dst] = pages[:, src]
    return pages


# ---------------------------------------------------------------------------
# Param init (seeded torch.Generator; the draws differ from jax.random's)
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    # scaled in place: drawing a large embedding holds one f32 copy, not two
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32):
    p = {"kernel": _normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def project(qa: QArith, x, w):
    """``x`` (..., d_in) @ ``w`` (d_in, d_out): 16-bit inputs, f32
    accumulation, one nearest rounding. On the kernel route with bf16
    operands it is one :func:`~repro_torch.kernels.qmatmul.qmatmul` launch
    on the rows flattened to (rows, d_in), whose row bits do not depend on
    the row count; otherwise ``qa.einsum`` (cuBLAS on CUDA, which picks its
    kernel by the row count; the upcast product on the CPU)."""
    if _kernel_route(x, w):
        xc, wc = qa.cast(x), qa.cast(w)
        if xc.dtype == wc.dtype == torch.bfloat16:
            y = qmatmul(xc.reshape(-1, x.shape[-1]).contiguous(), wc.contiguous())
            return y.reshape(*x.shape[:-1], w.shape[-1])
    return qa.einsum("...d,df->...f", x, w)


def project_f32(qa: QArith, x, w):
    """``x`` (..., d_in) @ ``w`` (d_in, d_out) with the f32 result left
    unrounded: on the kernel route one launch of the f32-result entry
    :func:`~repro_torch.kernels.qmatmul.qmatmul_f32` (the K chain of
    :func:`project`'s, rows independent of the row count), otherwise
    ``qa.matmul_f32out``."""
    if _kernel_route(x, w):
        xc, wc = qa.cast(x), qa.cast(w)
        if xc.dtype == wc.dtype == torch.bfloat16:
            y = qmatmul_f32(xc.reshape(-1, x.shape[-1]).contiguous(), wc.contiguous())
            return y.reshape(*x.shape[:-1], w.shape[-1])
    return qa.matmul_f32out(x, w)


def project_row_parallel(qa: QArith, x, w):
    """A row-parallel product (``wo``, ``w_down``): :func:`project` in one
    process; under a model axis (:mod:`repro_torch.dist.axes`) ``x`` and
    ``w`` hold this rank's slice of the contracted features, and the model
    group's f32 partials are summed in rank order and rounded once, as the
    reference's all-reduce of f32 partials is (its backward: the
    replicated cotangent on this rank's partial)."""
    if axes.current() is None:
        return project(qa, x, w)
    return axes.row_parallel_sum(project_f32(qa, x, w), qa)


ROW_BLOCK = 8     # rows of one f32 product call on the kernel route


def f32_rows_product(a, b):
    """``a`` (..., K) @ ``b`` (K, N), both taken in f32 and the result left
    in f32: the reference's f32 einsums (the MoE router's, Mamba's
    ``dt_proj``). cuBLAS picks its f32 kernel by the row count, so on the
    kernel route this runs in fixed blocks of ROW_BLOCK rows (the last one
    zero-padded), every call of one shape: a row's bits then depend neither
    on the number of rows of the step nor on which rows share its block."""
    rows = a.to(torch.float32).reshape(-1, a.shape[-1])
    b = b.to(torch.float32)
    M = rows.shape[0]
    if M % ROW_BLOCK:
        rows = torch.cat([rows, rows.new_zeros((-M % ROW_BLOCK, rows.shape[1]))])
    out = torch.cat([torch.mm(blk, b) for blk in rows.split(ROW_BLOCK)])[:M]
    return out.reshape(*a.shape[:-1], b.shape[-1])


def dense(qa: QArith, p, x, *, row_parallel: bool = False):
    """``x @ kernel + bias``. Under a model axis a column-parallel kernel
    holds this rank's output columns and the replicated bias adds its
    matching slice; a ``row_parallel`` kernel (``wo``) holds this rank's
    input features (:func:`project_row_parallel`) and the whole bias adds."""
    y = (project_row_parallel if row_parallel else project)(qa, x, p["kernel"])
    if "bias" in p:
        y = qa.add(y, axes.local_slice(p["bias"], y.shape[-1]))
    return y


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype=torch.float32):
    return {"embedding": _normal(gen, (vocab, d_model), 1.0 / math.sqrt(d_model), dtype)}


def norm_init(kind: str, d: int, dtype=torch.float32, device=None):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(qa: QArith, kind: str, p, x):
    """On the kernel route RMSNorm's f32 mean of squares is
    :func:`~repro_torch.kernels.row_mean_sq.row_mean_sq`, summed in an
    order fixed by the row length."""
    if kind == "ln":
        return qa.layernorm(x, p["scale"], p["bias"])
    return qa.rmsnorm(x, p["scale"], mean_sq=row_mean_sq if _kernel_route(x) else None)


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


def mrope(x, positions_3d, sections, theta: float = 10000.0):
    """Qwen2-VL M-RoPE: the rotary frequencies split into (t, h, w)
    sections, each frequency rotated by the angle of its section's
    position stream. x: (B,S,H,D); positions_3d: (3,B,S). The angles are
    :func:`rope`'s, in f32, and x is rounded once; with t = h = w it is
    :func:`rope` bit for bit."""
    d = x.shape[-1]
    ang_full = _rope_angles(positions_3d, d, theta)       # (3,B,S,D/2)
    sel = torch.tensor([i for i, sec in enumerate(sections) for _ in range(sec)],
                       dtype=torch.long, device=x.device)  # (D/2,) section id
    if sel.shape[0] != d // 2:
        raise ValueError(f"mrope sections {tuple(sections)} do not cover the {d // 2} "
                         "rotary frequencies")
    streams = ang_full.movedim(0, -1)                      # (B,S,D/2,3)
    ang = torch.gather(streams, -1, sel[:, None].expand(*streams.shape[:-1], 1))[..., 0]
    cos = torch.cos(ang)[..., None, :]                    # (B,S,1,D/2)
    sin = torch.sin(ang)[..., None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + causal/SWA masks, flash-chunked for long sequences)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _mask(q_pos, k_pos, *, causal: bool, window):
    # q_pos: (Sq,), k_pos: (Sk,) → bool (Sq, Sk) "allowed"
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    ok &= k_pos[None, :] >= 0            # ring-buffer empty slots carry pos=-1
    return ok


def _expand_kv(k, n_heads: int):
    """GQA → MHA: repeat each KV head over its group of q heads (the
    reference's ``jnp.repeat`` along the head axis)."""
    Hkv = k.shape[2]
    if Hkv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // Hkv, dim=2)


def _scores(q, kc, q_pos, k_pos, *, causal, window, softcap):
    """Masked f32 scores (B,H,Sq,C) of q (B,H,Sq,D) against a chunk kc
    (B,H,C,D), both in the compute dtype, and the softcap's tanh term.
    The product has an f32 result: one tensor-core GEMM for 16-bit
    operands on CUDA (:func:`f32_product`), else kc upcast before the
    transpose and an f32 product. Divisors are tensors: CUDA divides by a
    Python scalar through its reciprocal."""
    D = q.shape[-1]
    if on_tensor_cores(q, kc):
        s = f32_product(q, kc.transpose(-1, -2))
    else:
        s = torch.matmul(q.to(torch.float32), kc.to(torch.float32).transpose(-1, -2))
    s = s / s.new_tensor(math.sqrt(D))
    tanh_term = None
    if softcap:
        tanh_term = torch.tanh(s / s.new_tensor(softcap))
        s = softcap * tanh_term
    ok = _mask(q_pos, k_pos, causal=causal, window=window)
    return torch.where(ok, s, NEG_INF), tanh_term


class _FlashCore(torch.autograd.Function):
    """Flash attention with a recomputing backward (reference
    ``_flash_core``, ``layers.py:163-273``): residuals are just
    (q, k, v, out, lse); the backward recomputes p per KV chunk in the
    reference's op order — ``Drow`` = Σ dout·out, ds rounded to the
    compute dtype, dq accumulated in f32.

    q, k, v: (B,S,H,D) in the compute dtype (k, v already expanded to H
    heads). Returns out (B,H,Sq,D) in the compute dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, softcap):
        dtype = q.dtype
        B, Sq, H, D = q.shape
        Sk = k.shape[1]
        kw = dict(causal=causal, window=window, softcap=softcap)
        qh = q.transpose(1, 2)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)      # (B,H,Sk,D)
        q_pos = torch.arange(Sq, device=q.device)
        m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
        for j in range(Sk // chunk):
            sl = slice(j * chunk, (j + 1) * chunk)
            k_pos = torch.arange(sl.start, sl.stop, device=q.device)
            s, _ = _scores(qh, kh[:, :, sl], q_pos, k_pos, **kw)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + f32_product(p.to(dtype), vh[:, :, sl])
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        out = (acc / l_safe[..., None]).to(dtype)
        lse = m + torch.log(l_safe)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (chunk, kw)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        chunk, kw = ctx.cfg
        dtype = q.dtype
        D = q.shape[-1]
        Sk = k.shape[1]
        dout = dout.to(dtype)
        qh = q.transpose(1, 2)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
        q_pos = torch.arange(q.shape[1], device=q.device)
        # row term: D_i = Σ_d dout·out
        Drow = (dout.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)
        dq = torch.zeros(qh.shape, dtype=torch.float32, device=q.device)
        dks, dvs = [], []
        for j in range(Sk // chunk):
            sl = slice(j * chunk, (j + 1) * chunk)
            k_pos = torch.arange(sl.start, sl.stop, device=q.device)
            kc = kh[:, :, sl]
            s, tanh_term = _scores(qh, kc, q_pos, k_pos, **kw)
            p = torch.exp(s - lse[..., None])                # (B,H,Sq,C)
            dvs.append(f32_product(p.to(dtype).transpose(-1, -2), dout).to(dtype))
            dp = f32_product(dout, vh[:, :, sl].transpose(-1, -2))
            ds = p * (dp - Drow[..., None])
            if kw["softcap"]:
                ds = ds * (1.0 - torch.square(tanh_term))
            ds = (ds / ds.new_tensor(math.sqrt(D))).to(dtype)
            dq = dq + f32_product(ds, kc)
            dks.append(f32_product(ds.transpose(-1, -2), qh).to(dtype))
        dk = torch.cat(dks, dim=2).transpose(1, 2)
        dv = torch.cat(dvs, dim=2).transpose(1, 2)
        return dq.transpose(1, 2).to(q.dtype), dk, dv, None, None, None, None


def flash_attention(qa: QArith, q, k, v, *, q_offset=0, causal=True,
                    window=None, chunk: int = 1024, softcap=None):
    """Online-softmax attention over KV chunks (memory O(Sq·chunk)).

    q: (B,Sq,Hq,D); k,v: (B,Sk,Hkv,D). One fused op per the FMAC model:
    f32 internals, single rounding of the output. The backward recomputes
    p per chunk (no per-chunk probabilities kept). Under a model axis q
    holds this rank's heads (the reference's zero-padded head count
    split, :func:`head_plan`) and k, v the kv heads they read; every head's
    arithmetic is one process's.
    """
    Hq = q.shape[2]
    Sk = k.shape[1]
    del q_offset  # full-sequence path starts at 0; decode uses decode_attention
    chunk_eff = min(chunk, Sk)
    if Sk % chunk_eff:
        raise ValueError(f"key length {Sk} is not a multiple of the chunk {chunk_eff}")
    out = _FlashCore.apply(q, _expand_kv(k, Hq), _expand_kv(v, Hq), bool(causal),
                           window, int(chunk_eff), softcap)   # (B,H,Sq,D)
    return qa.cast(out.transpose(1, 2))


def attention_as_lanes(q, k_cache, v_cache, k_pos, q_pos, *, window=None,
                       softcap=None, p_dtype=torch.bfloat16):
    """Every query row of ``q`` (B,S,Hq,D) as a decode lane of its own:
    B·S lanes, lane b·S+i at position ``q_pos[b, i]`` (−1 ⇒ exact zeros)
    reading lane b's contiguous cache in place (the decode kernel's lane →
    cache-row map; none for S=1). A row's visible keys, and so the kernel's
    split of them, are those of the single-token step at its position, so
    the row gets that step's bits. One launch of
    :func:`~repro_torch.kernels.decode_attention.fused_decode_attention`
    (its plain version for CPU tensors); returns f32 (B,S,Hq,D), unrounded."""
    B, S = q.shape[:2]
    lanes = None if S == 1 else torch.arange(
        B, dtype=torch.int32, device=q.device).repeat_interleave(S)
    out = fused_decode_attention(q.reshape(B * S, 1, *q.shape[2:]).contiguous(), k_cache,
                                 v_cache, k_pos, q_pos.reshape(B * S).to(torch.int32),
                                 lane_rows=lanes, window=window, softcap=softcap,
                                 p_dtype=p_dtype)
    return out.reshape(q.shape)


def paged_attention_as_lanes(q, k_pages, v_pages, pos_pages, block_table, q_pos, *,
                             window=None, softcap=None, p_dtype=torch.bfloat16):
    """:func:`attention_as_lanes` over the paged pool: lane b·S+i takes
    lane b's block-table row (repeated S times). One launch of
    :func:`~repro_torch.kernels.decode_attention.fused_paged_decode_attention`
    (its plain version for CPU tensors); returns f32 (B,S,Hq,D)."""
    B, S = q.shape[:2]
    table = block_table if S == 1 else block_table.repeat_interleave(S, dim=0)
    out = fused_paged_decode_attention(
        q.reshape(B * S, 1, *q.shape[2:]).contiguous(), k_pages, v_pages, pos_pages,
        table.contiguous(), q_pos.reshape(B * S).to(torch.int32), window=window,
        softcap=softcap, p_dtype=p_dtype)
    return out.reshape(q.shape)


def decode_attention(qa: QArith, q, k_cache, v_cache, k_pos, *, q_pos,
                     window=None, softcap=None):
    """Attention of one query token, or a chunk of them, per lane against
    a KV cache.

    q: (B,S,Hq,D); caches: (B,Sc,Hkv,D); k_pos: (B,Sc) i32 (−1 ⇒ empty
    cell); q_pos: (B,) i32 for S=1 (−1 ⇒ parked lane) or (B,S) per-query
    positions (−1 ⇒ masked query row: chunk padding). Inside a
    :func:`repro_torch.kernels.dispatch.fused_decode` context S=1 runs the
    fused decode kernel, and on CUDA so does S>1 (chunked prefill), each
    query row a lane of its own (:func:`attention_as_lanes`; padding rows
    give zeros). Otherwise S=1 runs the kernel's plain version and S>1 the
    plain multi-query path: every query row masks the same (Sc,) cache
    axis, so a row reduces over the keys as the S=1 path does (reference
    ``layers.py:358-379``). All give one output rounding.
    """
    B, S = q.shape[:2]
    if dispatch.fused_decode_enabled() and (S == 1 or q.device.type == "cuda"):
        return qa.cast(attention_as_lanes(q, k_cache, v_cache, k_pos, q_pos, window=window,
                                          softcap=softcap, p_dtype=qa.dtype))
    if S == 1:
        out = decode_attention_ref(q, k_cache, v_cache, k_pos, q_pos.reshape(B),
                                   window=window, softcap=softcap, p_dtype=qa.dtype)
        return qa.cast(out)
    Hq, D = q.shape[2:]
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    tensor_cores = on_tensor_cores(q, k_cache)
    if tensor_cores:    # per (lane, kv head): (S·G, D) @ (D, Sc), an f32 result
        s = f32_product(qg.permute(0, 2, 1, 3, 4).reshape(B, Hkv, S * G, D),
                        k_cache.permute(0, 2, 3, 1))
        s = s.reshape(B, Hkv, S, G, -1).permute(0, 2, 1, 3, 4)
    else:
        s = torch.einsum("bshgd,bkhd->bshgk", qg.to(torch.float32),
                         k_cache.to(torch.float32))
    s = s * (1.0 / math.sqrt(D))
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp = q_pos.reshape(B, S)[:, :, None, None, None]
    kp = k_pos[:, None, None, None, :]
    ok = (kp <= qp) & (kp >= 0)
    if window is not None:
        ok &= qp - kp < window
    s = torch.where(ok, s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(qa.dtype)
    if tensor_cores:    # per (lane, kv head): (S·G, Sc) @ (Sc, D), an f32 result
        out = f32_product(p.permute(0, 2, 1, 3, 4).reshape(B, Hkv, S * G, -1),
                          v_cache.permute(0, 2, 1, 3))
        out = out.reshape(B, Hkv, S, G, D).permute(0, 2, 1, 3, 4)
    else:
        out = torch.einsum("bshgk,bkhd->bshgd", p.to(torch.float32),
                           v_cache.to(torch.float32))
    return qa.cast(out.reshape(B, S, Hq, D))


def attention_init(gen: torch.Generator, cfg, dtype=torch.float32):
    hd = cfg.head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, bias=cfg.qkv_bias, dtype=dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, dtype=dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, dtype=dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype=dtype),
    }


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """This rank's attention heads on a model axis of ``size`` ranks.

    Query heads split as the reference's flash path splits them: padded
    with zero heads to a multiple of the axis (``padded``,
    ``src/repro/dist/axes.py::padded_head_count``), ``padded / size``
    consecutive heads per rank (``q_heads``). Where the axis divides
    ``n_heads`` these are the heads of the rank's ``wq`` columns;
    otherwise a shard of ``wq`` ends inside a head, so q is gathered
    (``gather_q``) and the rank takes its padded share. Where the axis
    divides ``n_kv_heads`` the rank's ``wk``/``wv`` columns are its kv
    heads; otherwise k and v are gathered (``gather_kv``) and the rank
    keeps the kv heads its query heads read (``kv_index``): each once
    when its query heads form whole consecutive groups, else one per
    query head (a rank whose heads straddle two groups). The reference's
    ``cache_specs`` replicates such a cache's kv heads; the port's cache
    holds just ``kv_index``."""
    n_heads: int
    n_kv_heads: int
    size: int = 1
    rank: int = 0

    @property
    def gather_q(self) -> bool:
        return self.n_heads % self.size != 0

    @property
    def gather_kv(self) -> bool:
        return self.n_kv_heads % self.size != 0

    @property
    def padded(self) -> int:
        return -(-self.n_heads // self.size) * self.size

    @property
    def q_heads(self) -> range:
        per = self.padded // self.size
        return range(self.rank * per, (self.rank + 1) * per)

    @property
    def kv_index(self) -> tuple[int, ...]:
        if not self.gather_kv:
            per = self.n_kv_heads // self.size
            return tuple(range(self.rank * per, (self.rank + 1) * per))
        group = self.n_heads // self.n_kv_heads
        reads = [min(h, self.n_heads - 1) // group for h in self.q_heads]
        kept = sorted(set(reads))
        g = len(reads) // len(kept)
        if len(reads) % len(kept) == 0 and reads == [k for k in kept for _ in range(g)]:
            return tuple(kept)
        return tuple(reads)


def head_plan(cfg, size: int | None = None, rank: int | None = None) -> HeadPlan:
    """The :class:`HeadPlan` of ``cfg`` on a model axis of ``size`` ranks
    at ``rank`` (default: the installed axis, or one process)."""
    if size is None:
        axis = axes.current()
        size, rank = (1, 0) if axis is None else (axis.size, axis.rank)
    return HeadPlan(cfg.n_heads, cfg.n_kv_heads, size, rank or 0)


def local_q(qa: QArith, p, x, plan: HeadPlan, hd: int):
    """This rank's query heads (B,S,Hq_local,hd) of ``x`` (the column
    group's shared input): its ``wq`` columns, or, where they end inside
    a head, the gathered q zero-padded to ``plan.padded`` heads and
    narrowed to ``plan.q_heads``."""
    q = dense(qa, p, x)
    B, S = q.shape[:2]
    if not plan.gather_q:
        return q.reshape(B, S, -1, hd)
    q, = axes.gather_shards(q)
    q = q.reshape(B, S, plan.n_heads, hd)
    q = torch.cat([q, q.new_zeros((B, S, plan.padded - plan.n_heads, hd))], dim=2)
    return q[:, :, plan.q_heads.start:plan.q_heads.stop]


def local_kv(qa: QArith, pk, pv, x, plan: HeadPlan, hd: int):
    """This rank's k and v heads (B,S,len(plan.kv_index),hd): its
    ``wk``/``wv`` columns, or the gathered heads (one collective for
    both) at ``plan.kv_index``."""
    k, v = dense(qa, pk, x), dense(qa, pv, x)
    B, S = k.shape[:2]
    if not plan.gather_kv:
        return k.reshape(B, S, -1, hd), v.reshape(B, S, -1, hd)
    idx = torch.tensor(plan.kv_index, dtype=torch.long, device=k.device)
    return tuple(t.reshape(B, S, plan.n_kv_heads, hd).index_select(2, idx)
                 for t in axes.gather_shards(k, v))


def attention_out(qa: QArith, p, out, plan: HeadPlan):
    """``wo`` (row-parallel) of this rank's head outputs (B,S,H_local,hd).
    Where its heads are the padded split's, the outputs are gathered, the
    pad heads dropped and the rows of this rank's ``wo`` shard taken."""
    B, S = out.shape[:2]
    out = out.reshape(B, S, -1)
    if plan.gather_q:
        hd = out.shape[-1] // len(plan.q_heads)
        rows = p["kernel"].shape[-2]
        full, = axes.gather_shards(out)
        out = full[..., :plan.n_heads * hd].narrow(-1, plan.rank * rows, rows)
    return dense(qa, p, out, row_parallel=True)


def attention_apply(qa: QArith, p, x, cfg, *, positions, causal: bool = True, cache=None,
                    window=None, chunk: int = 1024, block_table=None,
                    mrope_positions=None):
    """Full-sequence attention (``cache=None``: training, the reference's
    flash branch; ``causal=False`` for an encoder), or S decode tokens per
    lane against a KV cache (serving). x: (B,S,Dm); positions: (B,S).
    Returns ``(out, cache)``. The rotary embedding follows the reference's
    three-way branch: :func:`mrope` when ``cfg.rope_type == "mrope"`` and
    ``mrope_positions`` ((3,B,S)) are given, none when ``rope_type ==
    "none"`` (whisper), standard :func:`rope` on ``positions`` otherwise.

    Decoding, positions are the tokens' per-lane depths, −1 for a parked
    lane or a chunk's padding token. Two cache layouts, both written **in
    place** (the reference returns a new cache from a donated buffer):

    * contiguous tuple ``(k_cache, v_cache, k_pos)``: a token lands at cell
      ``pos % Sc`` of its lane. The reference drops the write of a token at
      position −1 as out of range; here a padding token at chunk index j
      rewrites the cell ``(pos_0 + j) % Sc`` (``pos_0``: the lane's first
      position, 0 for a parked lane) with its own current contents. A
      lane's real tokens sit at consecutive positions from index 0 and its
      padding after them, so for S ≤ Sc every write of one lane hits its own
      cell: no two writes of a step race for a cell.
    * paged dict ``{"k_pages", "v_pages", "pos_pages"}`` — a shared
      (R,P,Hkv,D) pool plus a per-lane ``block_table`` (B, n_blocks) of
      physical rows (reference ``layers.py:440-477``). Row R−1 is the null
      page: unmapped blocks point there and real tokens never write there.
      Dropped writes (padding, parked lanes, and — a scheduler-bug guard —
      a real token aimed at an unmapped block) go to the null row with
      position −1, so its positions stay −1 and gathered null blocks mask
      out. Token at logical position p lands at view index p, so the paged
      view equals a contiguous cache of the same length. Inside
      ``fused_decode`` the paged kernel runs on the pool for S=1, and on
      CUDA for S>1 too, each query row a lane
      (:func:`paged_attention_as_lanes`); otherwise the gathered view
      ``pages[block_table]`` goes to :func:`decode_attention`.
    """
    B, S, _ = x.shape
    hd = cfg.head_dim
    # this rank's heads: all of them in one process, its share on a model
    # axis (head_plan; the decode kernels see G = Hq/Hkv). RoPE rotates
    # pairs (i, i + hd/2), so a gathered head is rotated whole
    plan = head_plan(cfg)
    x = axes.copy_to_model(x)       # the column-parallel group's shared input
    q = local_q(qa, p["wq"], x, plan, hd)
    k, v = local_kv(qa, p["wk"], p["wv"], x, plan, hd)
    Hq, Hkv = q.shape[2], k.shape[2]
    if cfg.rope_type == "mrope" and mrope_positions is not None:
        q = mrope(q, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
        k = mrope(k, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
    elif cfg.rope_type != "none":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = flash_attention(qa, q, k, v, causal=causal, window=window, chunk=chunk,
                              softcap=cfg.attn_logit_softcap)
        return attention_out(qa, p["wo"], out, plan), None

    tpos = positions.reshape(B, S).to(torch.int32)
    live = tpos >= 0
    q_pos = tpos[:, -1] if S == 1 else tpos
    if isinstance(cache, dict):
        if block_table is None:
            raise ValueError("the paged cache needs a block table")
        kp, vp, pp = cache["k_pages"], cache["v_pages"], cache["pos_pages"]
        R, P = pp.shape
        n_blocks = block_table.shape[1]
        blk = torch.where(live, tpos // P, 0).clamp(0, n_blocks - 1)
        page = torch.gather(block_table, 1, blk.long())
        write = live & (page < R - 1)
        page = torch.where(write, page, R - 1).reshape(-1).long()
        off = torch.where(live, tpos % P, 0).reshape(-1).long()
        kp[page, off] = k.reshape(B * S, Hkv, hd).to(kp.dtype)
        vp[page, off] = v.reshape(B * S, Hkv, hd).to(vp.dtype)
        pp[page, off] = torch.where(write, tpos, -1).reshape(-1)
        if dispatch.fused_decode_enabled() and (S == 1 or x.device.type == "cuda"):
            out = qa.cast(paged_attention_as_lanes(
                q, kp, vp, pp, block_table, q_pos, window=window,
                softcap=cfg.attn_logit_softcap, p_dtype=qa.dtype))
        else:
            table = block_table.long()
            view = (B, n_blocks * P)
            out = decode_attention(
                qa, q, kp[table].reshape(*view, Hkv, hd),
                vp[table].reshape(*view, Hkv, hd),
                pp[table].reshape(view), q_pos=q_pos, window=window,
                softcap=cfg.attn_logit_softcap)
    else:
        k_cache, v_cache, k_pos = cache
        Sc = k_cache.shape[1]
        if S > Sc:
            raise ValueError(f"a chunk of {S} tokens overruns the {Sc}-cell cache")
        lane = torch.arange(B, device=x.device)[:, None].expand(B, S)
        first = torch.clamp(tpos[:, :1], min=0)
        offs = torch.arange(S, device=x.device, dtype=torch.int32)[None, :]
        slot = torch.where(live, tpos, first + offs) % Sc
        keep = live[..., None, None]
        k_cache[lane, slot] = torch.where(keep, k.to(k_cache.dtype), k_cache[lane, slot])
        v_cache[lane, slot] = torch.where(keep, v.to(v_cache.dtype), v_cache[lane, slot])
        k_pos[lane, slot] = torch.where(live, tpos, k_pos[lane, slot])
        out = decode_attention(qa, q, k_cache, v_cache, k_pos, q_pos=q_pos,
                               window=window, softcap=cfg.attn_logit_softcap)
    return attention_out(qa, p["wo"], out.reshape(B, S, Hq, hd), plan), cache
