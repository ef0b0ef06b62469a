"""Lock-step serving with a KV cache, greedy or sampled (port of
``repro.serve.decode``).

The reference (oracle) decode path: one fixed batch, every lane at the
same position, the prompt teacher-forced token by token through the same
decode step that then picks the continuation. The continuous-batching
engine must match it token for token; ``cache_len`` pins the cache to the
engine's pool length (attention reduces over the cache axis, so equal
shapes give equal reduction order). Matrix products pick their kernels
by the row count too — torch on the CPU and cuBLAS alike — so a parity
check also runs the reference at the engine's lane count.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.qarith import QArith
from repro_torch.dist import axes
from repro_torch.models import registry as R
from repro_torch.serve.cache import ENCDEC_ROUTE, cache_dtype

__all__ = ["generate"]


def generate(params, cfg, policy: PrecisionPolicy, prompts, *,
             max_new_tokens: int = 32, temperature: float = 0.0, seed: int = 0,
             cache_len: int | None = None, device=None, mesh=None) -> torch.Tensor:
    """prompts: (B, S_prompt) int → (B, S_prompt + max_new) int32.

    ``temperature == 0`` decodes greedily; ``temperature > 0`` draws each
    token from ``softmax(logits / temperature)`` with a ``torch.Generator``
    seeded from ``seed`` on the params' device (the reference's
    categorical draw: no top-k, no top-p). Runs on ``device`` (CUDA unless
    ``"cpu"``), where ``params`` must live. ``cache_len`` overrides the
    KV-cache length (default exactly ``S_prompt + max_new_tokens``);
    longer caches are masked out and change nothing semantically.

    ``mesh`` with a ``model`` axis above 1: ``params`` are this rank's
    shards, the decode steps run under that axis (the arithmetic of
    :func:`repro_torch.train.step.make_serve_step`'s) and the cache holds
    this rank's kv heads; every rank decodes the whole batch and returns
    the same tokens.
    """
    if cfg.encdec:
        raise ValueError(f"generate is decoder-only; encoder-decoder {ENCDEC_ROUTE}")
    dev = resolve_device(device)
    if params["embed"]["embedding"].device.type != dev.type:
        raise ValueError(f"params are on {params['embed']['embedding'].device}, "
                         f"generate runs on {dev}")
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    qa = QArith(policy)
    B, S0 = prompts.shape
    max_len = cache_len if cache_len is not None else S0 + max_new_tokens
    if max_len < S0 + max_new_tokens and not cfg.sub_quadratic:
        raise ValueError(f"cache_len {max_len} < prompt {S0} + "
                         f"max_new_tokens {max_new_tokens}")
    # same value dtype as the engine's CachePool — the parity contract
    # includes the KV storage rounding, not just the arithmetic
    cache = R.make_cache(params, cfg, batch_size=B, max_len=max_len,
                         dtype=cache_dtype(policy), mesh=mesh)
    with axes.model_axis(axes.for_mesh(mesh)):
        return _decode(qa, params, cfg, prompts, cache, max_new_tokens, temperature, seed)


def _decode(qa, params, cfg, prompts, cache, max_new_tokens, temperature, seed):
    B, S0 = prompts.shape
    dev = prompts.device

    def pos(t):
        return torch.full((B,), t, dtype=torch.int32, device=dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    out = [prompts]
    logits = None
    for t in range(S0):
        logits, cache = R.decode(qa, params, cfg, prompts[:, t:t + 1], cache, pos(t))
    for t in range(max_new_tokens):
        if temperature > 0:
            probs = torch.softmax(logits[:, -1].to(torch.float32) / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen).to(torch.int32)
        else:
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out.append(tok)
        if t < max_new_tokens - 1:
            logits, cache = R.decode(qa, params, cfg, tok, cache, pos(S0 + t))
    return torch.cat(out, dim=1)
