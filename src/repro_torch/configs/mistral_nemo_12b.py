"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407]. Dense GQA, 128k ctx."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="lm",
    n_layers=40, d_model=5120, vocab=131072,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, norm="rms", tie_embeddings=False,
    rope_theta=1000000.0,
    notes="dense GQA 128k-ctx; full attention -> long_500k skipped",
)
