"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01]. Dense GQA, no biases,
LayerNorm, tied embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="lm",
    n_layers=40, d_model=8192, vocab=256000,
    n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, norm="ln", tie_embeddings=True,
    rope_theta=8000000.0,
    notes="dense GQA no-bias; full attention -> long_500k skipped",
)
