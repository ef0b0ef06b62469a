"""Architecture configuration dataclass (copy of ``repro.configs.base``).

Every architecture is a :class:`ModelConfig`; ``reduced()`` derives the
CPU test variant (same family and features, tiny dims). The port keeps
its own copy so that it never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # lm | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    vocab: int
    # attention (0 heads = attention-free)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 128
    qkv_bias: bool = False
    swa_window: Optional[int] = None      # sliding-window size (None = full)
    rope_theta: float = 10000.0
    rope_type: str = "std"                # std | mrope
    mrope_sections: tuple[int, ...] = ()  # head_dim/2 split for t/h/w
    # mlp / moe
    d_ff: int = 0
    n_experts: int = 0                    # 0 = dense
    top_k: int = 1
    shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_strategy: str = "onehot"          # onehot | grouped | gather (§Perf)
    moe_group_size: int = 1024            # routing-group tokens (grouped)
    # norm / embeddings
    norm: str = "rms"                     # rms | ln
    tie_embeddings: bool = True
    attn_logit_softcap: Optional[float] = None
    # ssm (mamba1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0                      # 0 → ceil(d_model/16)
    # hybrid (recurrentgemma): repeating block pattern
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0                    # RG-LRU width (0 → d_model)
    local_attn_window: int = 2048
    # enc-dec (whisper)
    encdec: bool = False
    n_enc_layers: int = 0
    max_source_len: int = 1500
    # activation recompute: save layer inputs every `scan_group` layers
    scan_group: int = 1
    act_fn: str = "silu"                  # silu | gelu
    # sub-quadratic? (drives long_500k applicability)
    notes: str = ""

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    @property
    def sub_quadratic(self) -> bool:
        return (self.attention_free or bool(self.block_pattern)
                or self.swa_window is not None)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_eff(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        pattern = self.block_pattern[:3] if self.block_pattern else ()
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 3 if not pattern else len(pattern)),
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=128,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=512,
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32,
            n_experts=min(self.n_experts, 4),
            ssm_state=min(self.ssm_state, 8),
            dt_rank=8 if self.ssm_state else 0,
            lru_width=128 if self.lru_width or self.block_pattern else 0,
            local_attn_window=64,
            swa_window=64 if self.swa_window else None,
            mrope_sections=(4, 6, 6) if self.mrope_sections else (),
            max_source_len=64,
            scan_group=1,
        )
