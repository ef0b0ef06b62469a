"""Numeric core: formats, precision policies, FMAC arithmetic."""
from repro_torch.core.policy import PRESETS, PrecisionPolicy, get_policy
from repro_torch.core.qarith import QArith

__all__ = ["PRESETS", "PrecisionPolicy", "QArith", "get_policy"]
