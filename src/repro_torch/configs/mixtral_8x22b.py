"""Mixtral-8x22B [arXiv:2401.04088]. 8 experts top-2, SWA per assignment.

8 experts do not divide the 16-way model axis -> TP-inside-expert
(d_ff 16384 sharded 16-way), experts replicated; SWA window 4096 makes it
sub-quadratic -> long_500k runs with a ring-buffer KV cache.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="lm",
    n_layers=56, d_model=6144, vocab=32768,
    n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, n_experts=8, top_k=2, moe_strategy="grouped",
    swa_window=4096, rope_theta=1000000.0, norm="rms", tie_embeddings=False,
    notes="moe top-2; SWA 4096 -> long_500k runnable",
)
