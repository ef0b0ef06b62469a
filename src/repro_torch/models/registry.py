"""Architecture registry and the model API the serve and train paths use
(port of ``repro.models.registry``: ``get_config``, ``init``,
``forward_logits``, ``make_cache``, ``decode``).

Every architecture of the reference is ported: dense GQA (qwen2.5, yi,
mistral-nemo, command-r), mixture-of-experts (mixtral, llama4-scout),
Mamba (falcon-mamba), the RG-LRU hybrid (recurrentgemma), the M-RoPE vlm
backbone (qwen2-vl) and the encoder-decoder (whisper).

Batch dicts, as the reference's:

* lm:    ``{"tokens": (B,S) int, "labels": (B,S) int}``
* vlm:   ``{"embeds": (B,S,D) float, "mrope_positions": (3,B,S) int32,
  "labels"}``, or the lm batch (text only: standard RoPE)
* audio: ``{"src_embeds": (B,S_src,D) float, "tokens": (B,S_tgt) int,
  "labels"}``

The encoder-decoder decodes in lock-step: ``make_cache(..., batch=,
qa=)`` encodes the source once, then ``decode`` advances every lane one
token (the reference's path; its serving engine is decoder-only).
"""
from __future__ import annotations

import importlib

import torch

from repro_torch import resolve_device
from repro_torch.core.qarith import QArith
from repro_torch.dist import partition as PT
from repro_torch.dist import axes
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["ARCH_IDS", "TGT_LEN_ENCDEC", "get_config", "init", "forward_logits",
           "make_cache", "decode"]

ARCH_IDS = (
    "llama4-scout-17b-a16e", "mixtral-8x22b", "command-r-35b", "yi-9b",
    "qwen2.5-3b", "mistral-nemo-12b", "qwen2-vl-7b", "whisper-base",
    "falcon-mamba-7b", "recurrentgemma-2b",
)

_MODULES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "mixtral-8x22b": "mixtral_8x22b",
    "command-r-35b": "command_r_35b",
    "yi-9b": "yi_9b",
    "qwen2.5-3b": "qwen2_5_3b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "whisper-base": "whisper_base",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

# Whisper's decoder is designed for 448 tokens: the teacher-forced target
# length of its train batches (the source frames carry the sequence length)
TGT_LEN_ENCDEC = 448


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


def init(cfg, seed: int, dtype=torch.float32, *, device=None):
    """Parameters of ``cfg`` drawn from a ``torch.Generator`` seeded with
    ``seed``, made directly on ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if cfg.encdec:
        return ED.init_encdec(cfg, gen, dtype)
    return T.init_lm(cfg, gen, dtype)


def forward_logits(qa: QArith, params, cfg, batch: dict, *, remat: bool = True,
                   attn_chunk: int = 1024):
    """Teacher-forced logits (B,S,V) f32 of any family's batch; under a
    model axis this rank's vocab columns (B,S,V/size), which the loss
    takes through :func:`repro_torch.dist.axes.vocab_parallel_xent`."""
    if cfg.encdec:
        enc_out = ED.encode(qa, params, cfg, batch["src_embeds"], remat=remat,
                            attn_chunk=attn_chunk)
        return ED.decoder_forward(qa, params, cfg, batch["tokens"], enc_out, remat=remat,
                                  attn_chunk=attn_chunk)
    tokens = batch.get("tokens", batch.get("embeds"))
    return T.forward(qa, params, cfg, tokens, mrope_positions=batch.get("mrope_positions"),
                     remat=remat, attn_chunk=attn_chunk)


def _local_widths(cfg, mesh) -> dict:
    """The cache widths of this rank's blocks on ``mesh``'s model axis
    (the whole ones without): the kv heads its attention reads
    (``layers.head_plan``), its share of Mamba's ``d_inner`` and of
    RG-LRU's channels."""
    mp = PT.mp_size(mesh)
    rank = mesh.index(PT.MODEL_AXIS) if mp > 1 else 0
    out = {"d_inner": cfg.d_inner // mp, "lru_width": (cfg.lru_width or cfg.d_model) // mp}
    if cfg.n_heads:
        out["kv_heads"] = len(L.head_plan(cfg, mp, rank).kv_index)
    return out


def make_cache(params, cfg, *, batch_size: int, max_len: int, dtype=torch.bfloat16,
               page_size=None, n_rows=None, batch: dict | None = None,
               qa: QArith | None = None, mesh=None):
    """Decode cache for ``batch_size`` lanes, on the parameters' device;
    ``page_size``/``n_rows`` build the paged pool instead (on a data axis
    above 1 this rank's rows of it, ``partition.page_rows``; the caller
    passes its own lanes' count as for a contiguous cache). On ``mesh``'s
    model axis ``params`` are this rank's shards and the cache holds this
    rank's share: the kv heads its attention reads (``layers.head_plan``),
    its Mamba and RG-LRU channels; ``mesh`` refuses what the port does not
    serve on it (``partition.serve_refusal``). The encoder-decoder encodes
    ``batch["src_embeds"]`` under ``qa`` (and the model axis) into its
    cross K/V (it has no paged pool), its attention over the whole source
    in one flash chunk: the reference's chunk of 1024 does not divide
    whisper's 1500 frames, and the chunk only orders the sums."""
    reason = PT.serve_refusal(cfg, mesh)
    if reason is not None:
        raise ValueError(reason)
    if cfg.encdec:
        if page_size is not None:
            raise ValueError("paged KV cache is not supported for enc-dec")
        if batch is None or qa is None:
            raise ValueError("the enc-dec cache encodes its source: pass batch= "
                             "(with src_embeds) and qa=")
        src = batch["src_embeds"]
        with axes.model_axis(axes.for_mesh(mesh)):
            enc_out = ED.encode(qa, params, cfg, src, remat=False, attn_chunk=src.shape[1])
            return ED.init_decode_cache(cfg, params, qa, enc_out, batch_size, max_len, dtype)
    if page_size is not None:
        lo, hi = PT.page_rows(n_rows, mesh)      # this data rank's rows
        n_rows = hi - lo
    return T.init_cache(cfg, batch_size, max_len, dtype, page_size=page_size,
                        n_rows=n_rows, device=params["embed"]["embedding"].device,
                        **_local_widths(cfg, mesh))


def decode(qa: QArith, params, cfg, token, cache, cache_pos, *, mrope_positions=None,
           block_table=None, out_rows=None):
    if cfg.encdec:
        if block_table is not None:
            raise ValueError("paged KV cache is not supported for enc-dec")
        return ED.encdec_decode_step(qa, params, cfg, token, cache, cache_pos)
    return T.decode_step(qa, params, cfg, token, cache, cache_pos,
                         mrope_positions=mrope_positions, block_table=block_table,
                         out_rows=out_rows)
