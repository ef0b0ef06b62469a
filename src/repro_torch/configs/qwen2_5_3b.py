"""Qwen2.5-3B [hf:Qwen/Qwen2.5-3B]. Dense GQA with QKV bias, tied embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="lm",
    n_layers=36, d_model=2048, vocab=151936,
    n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, qkv_bias=True, norm="rms", tie_embeddings=True,
    rope_theta=1000000.0,
    notes="GQA + QKV bias; full attention -> long_500k skipped",
)
