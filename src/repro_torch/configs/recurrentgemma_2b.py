"""RecurrentGemma-2B [arXiv:2402.19427]. Griffin: RG-LRU recurrent blocks +
local attention (window 2048), pattern (rec, rec, local_attn); MQA kv=1."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, vocab=256000,
    n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, norm="rms", act_fn="gelu", tie_embeddings=True,
    block_pattern=("rec", "rec", "local_attn"),
    lru_width=2560, local_attn_window=2048, ssm_conv=4,
    notes="hybrid 1:2; sub-quadratic -> long_500k runnable",
)
