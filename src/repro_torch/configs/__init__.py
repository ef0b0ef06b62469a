"""Architecture configs ported so far (one module per arch)."""
from repro_torch.configs.base import ModelConfig

__all__ = ["ModelConfig"]
