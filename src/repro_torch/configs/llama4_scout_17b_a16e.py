"""Llama-4-Scout-17B-16E text backbone [hf:meta-llama/Llama-4-Scout-17B-16E].

MoE with 16 routed experts (top-1) + shared expert, early-fusion multimodal
(frontend stub per assignment: input_specs can supply embeddings). 40 heads
is not divisible by the 16-way model axis → attention params replicate on
"model" (see DESIGN.md §4); MoE experts shard 16-way (EP).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="lm",
    n_layers=48, d_model=5120, vocab=202048,
    n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, n_experts=16, top_k=1, shared_expert=True,
    moe_strategy="grouped",
    rope_theta=500000.0, norm="rms", tie_embeddings=False,
    notes="moe; early fusion; full attention -> long_500k skipped",
)
