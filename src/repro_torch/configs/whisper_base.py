"""Whisper-base backbone [arXiv:2212.04356]. Enc-dec; conv/mel frontend is a
stub supplying frame embeddings to the encoder. LayerNorm + GELU."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, vocab=51865,
    n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, norm="ln", act_fn="gelu", tie_embeddings=True,
    rope_type="none", encdec=True, n_enc_layers=6, max_source_len=1500,
    notes="enc-dec; decoder decode shapes use self+cross KV caches; "
          "full attention -> long_500k skipped",
)
