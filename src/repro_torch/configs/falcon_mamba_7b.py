"""Falcon-Mamba-7B [arXiv:2410.05355]. Pure Mamba-1 stack (attention-free);
O(1) recurrent state -> all decode shapes incl. long_500k runnable."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, vocab=65024,
    n_heads=0, n_kv_heads=0, d_ff=0,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    norm="rms", tie_embeddings=True,
    notes="mamba1; attention-free -> long_500k runnable",
)
