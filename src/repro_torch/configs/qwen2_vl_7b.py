"""Qwen2-VL-7B backbone [arXiv:2409.12191]. M-RoPE (t/h/w rotary sections);
vision frontend is a stub supplying patch embeddings + 3-D position ids."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, vocab=152064,
    n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, qkv_bias=True, norm="rms", tie_embeddings=False,
    rope_type="mrope", mrope_sections=(16, 24, 24), rope_theta=1000000.0,
    notes="vlm backbone; M-RoPE; 28 heads !% 16 -> attn replicated on model axis",
)
