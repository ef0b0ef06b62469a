"""Yi-9B [arXiv:2403.04652]. Llama-architecture dense GQA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="lm",
    n_layers=48, d_model=4096, vocab=64000,
    n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, norm="rms", tie_embeddings=False,
    rope_theta=10000.0,
    notes="llama-arch GQA; full attention -> long_500k skipped",
)
