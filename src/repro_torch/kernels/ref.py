"""The plain PyTorch versions of the kernels, under the oracle names of
``repro/kernels/ref.py``. Each lives beside its kernel; this module only
gathers them."""
from repro_torch.kernels.fused_adamw import fused_adamw_ref
from repro_torch.kernels.fused_sgd import fused_sgd_ref
from repro_torch.kernels.qmatmul import qmatmul_ref
from repro_torch.kernels.sr_cast import sr_cast_ref

__all__ = ["sr_cast_ref", "fused_adamw_ref", "fused_sgd_ref", "qmatmul_ref"]
