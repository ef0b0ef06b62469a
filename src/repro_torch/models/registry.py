"""Architecture registry and the model API the serve and train paths use
(port of ``repro.models.registry``: ``get_config``, ``init``,
``forward_logits``, ``make_cache``, ``decode``).

Every decoder-only family of the reference is ported: dense GQA (qwen2.5,
yi, mistral-nemo, command-r), mixture-of-experts (mixtral, llama4-scout),
Mamba (falcon-mamba) and the RG-LRU hybrid (recurrentgemma). The
encoder-decoder (whisper) and the M-RoPE backbone (qwen2-vl) raise "not
ported yet" with the ROADMAP item that ports them.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch import resolve_device
from repro_torch.core.qarith import QArith
from repro_torch.models import transformer as T

__all__ = ["ARCH_IDS", "get_config", "init", "forward_logits", "make_cache", "decode"]

# every architecture of the reference; _MODULES lists the ported ones
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
    "falcon-mamba-7b": "falcon_mamba_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

# the architectures still to port, and the ROADMAP item that ports each
_NOT_PORTED = {"whisper-base": "A4 item 5 (encoder-decoder)",
               "qwen2-vl-7b": "A4 item 6 (M-RoPE)"}


def get_config(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    if name not in _MODULES:
        raise NotImplementedError(f"arch {name!r} is not ported yet (ROADMAP "
                                  f"{_NOT_PORTED[name]}); ported: {tuple(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


def init(cfg, seed: int, dtype=torch.float32, *, device=None):
    """Parameters of ``cfg`` drawn from a ``torch.Generator`` seeded with
    ``seed``, made directly on ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return T.init_lm(cfg, gen, dtype)


def forward_logits(qa: QArith, params, cfg, batch: dict, *, remat: bool = True,
                   attn_chunk: int = 1024):
    """Teacher-forced logits (B,S,V) f32 of ``batch["tokens"]``."""
    return T.forward(qa, params, cfg, batch["tokens"], remat=remat,
                     attn_chunk=attn_chunk)


def make_cache(params, cfg, *, batch_size: int, max_len: int,
               dtype=torch.bfloat16, page_size=None, n_rows=None):
    """Decode cache for ``batch_size`` lanes, on the parameters' device;
    ``page_size``/``n_rows`` build the paged pool instead."""
    return T.init_cache(cfg, batch_size, max_len, dtype, page_size=page_size,
                        n_rows=n_rows, device=params["embed"]["embedding"].device)


def decode(qa: QArith, params, cfg, token, cache, cache_pos, *, block_table=None,
           out_rows=None):
    return T.decode_step(qa, params, cfg, token, cache, cache_pos,
                         block_table=block_table, out_rows=out_rows)
