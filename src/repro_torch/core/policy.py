"""Precision policies — the paper's Table 2 (port of ``repro.core.policy``).

Same presets, names and fields as the reference; the dtype properties
return torch dtypes.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.formats import BF16, FORMATS, FP32, FloatFormat

__all__ = ["PrecisionPolicy", "get_policy", "make_policy", "PRESETS"]


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    name: str
    param_format: FloatFormat          # storage format of model weights
    state_format: FloatFormat          # optimizer states (momentum, v, ...)
    compute_format: FloatFormat        # activations & gradients
    update_rounding: str               # "nearest" | "stochastic" | "exact"
    kahan: bool = False                # Kahan compensation on weight update
    master_weights: bool = False       # fp32 master copy (mixed / ablation)

    @property
    def native(self) -> bool:
        """True when all storage is native-dtype (bf16/f32): no f32-carrier
        grid simulation needed in forward/backward."""
        return (self.compute_format.name in ("bf16", "fp32")
                and self.param_format.name in ("bf16", "fp32"))

    @property
    def param_dtype(self) -> torch.dtype:
        if self.master_weights or self.param_format.name == "fp32":
            return torch.float32
        return torch.bfloat16 if self.param_format.name == "bf16" else torch.float32

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.compute_format.name == "fp32":
            return torch.float32
        if self.compute_format.name == "bf16":
            return torch.bfloat16
        if self.compute_format.name == "fp16":
            return torch.float16
        return torch.float32  # simulated grid carried in f32

    @property
    def state_dtype(self) -> torch.dtype:
        if self.state_format.name == "fp32":
            return torch.float32
        return torch.bfloat16 if self.state_format.name == "bf16" else torch.float32

    def tag(self) -> str:
        return self.name


def make_policy(name: str, *, storage: FloatFormat = BF16,
                update_rounding: str = "nearest", kahan: bool = False,
                master_weights: bool = False,
                compute: FloatFormat | None = None) -> PrecisionPolicy:
    return PrecisionPolicy(
        name=name,
        param_format=FP32 if master_weights else storage,
        state_format=storage,
        compute_format=compute or storage,
        update_rounding=update_rounding,
        kahan=kahan,
        master_weights=master_weights,
    )


PRESETS: dict[str, PrecisionPolicy] = {
    "fp32": PrecisionPolicy("fp32", FP32, FP32, FP32, "exact"),
    "mixed": PrecisionPolicy("mixed", FP32, FP32, BF16, "exact", master_weights=True),
    "bf16_standard": make_policy("bf16_standard"),
    "bf16_sr": make_policy("bf16_sr", update_rounding="stochastic"),
    "bf16_kahan": make_policy("bf16_kahan", kahan=True),
    "bf16_sr_kahan": make_policy("bf16_sr_kahan", update_rounding="stochastic", kahan=True),
    # Table 3 ablation: 16-bit everywhere except exact fp32 weights/updates
    "bf16_master": PrecisionPolicy("bf16_master", FP32, BF16, BF16, "exact", master_weights=True),
    # Fig 12: fp16 storage instead of bf16
    "fp16_sr": make_policy("fp16_sr", storage=FORMATS["fp16"], update_rounding="stochastic"),
    "fp16_kahan": make_policy("fp16_kahan", storage=FORMATS["fp16"], kahan=True),
    # Fig 10: sub-16-bit
    "bf14_sr": make_policy("bf14_sr", storage=FORMATS["bf14"], update_rounding="stochastic"),
    "bf14_kahan": make_policy("bf14_kahan", storage=FORMATS["bf14"], kahan=True),
    "bf12_sr": make_policy("bf12_sr", storage=FORMATS["bf12"], update_rounding="stochastic"),
    "bf12_kahan": make_policy("bf12_kahan", storage=FORMATS["bf12"], kahan=True),
    "bf10_sr": make_policy("bf10_sr", storage=FORMATS["bf10"], update_rounding="stochastic"),
    "bf10_kahan": make_policy("bf10_kahan", storage=FORMATS["bf10"], kahan=True),
}


def get_policy(name: str) -> PrecisionPolicy:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown precision policy {name!r}; known: {sorted(PRESETS)}") from None
