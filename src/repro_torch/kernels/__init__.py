"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and dispatch.

- sr_cast          — stochastic-rounding cast f32 → bf16 from explicit bits
- fused_adamw      — Algorithms 4/5 in one pass over memory (SR / Kahan), in place
- fused_sgd        — Algorithms 2/3 in one pass, in place
- qmatmul          — bf16-in / f32-accumulate / round-once FMAC matmul (Table 1)
- fused_decode_attention — single-token attention over the slotted KV pool
- philox           — the SR bits of a leaf from its Philox4x32-10 stream
- row_mean_sq      — RMSNorm's mean of squares in an order fixed by the row length
- dispatch         — routing of the serve step onto the kernels
- ops              — entry points that draw the SR bits from a torch.Generator
- ref              — the plain versions under the reference's oracle names

The names are those of ``repro.kernels``. Importing builds nothing: each
kernel is compiled at its first launch. The package attributes
``fused_adamw``, ``fused_sgd``, ``qmatmul`` and ``sr_cast`` are the
functions; their modules (with each kernel's ``LAUNCHES`` count) are
``sys.modules["repro_torch.kernels.<name>"]``, e.g. through
``importlib.import_module``.
"""
import sys

from repro_torch.kernels import dispatch, ops, philox, ref, row_mean_sq
from repro_torch.kernels.decode_attention import fused_decode_attention
from repro_torch.kernels.fused_adamw import fused_adamw
from repro_torch.kernels.fused_sgd import fused_sgd
from repro_torch.kernels.qmatmul import qmatmul
from repro_torch.kernels.sr_cast import sr_cast

__all__ = ["dispatch", "ops", "ref", "fused_adamw", "fused_decode_attention",
           "fused_sgd", "qmatmul", "sr_cast"]


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, by kernel name (beside the
    reference's exports, so not in ``__all__``)."""
    mod = {name: sys.modules[f"{__name__}.{name}"] for name in
           ("decode_attention", "fused_adamw", "fused_sgd", "philox", "qmatmul",
            "row_mean_sq", "sr_cast")}
    counts = {name: m.LAUNCHES for name, m in mod.items()}
    counts["paged_decode_attention"] = mod["decode_attention"].PAGED_LAUNCHES
    counts["qmatmul_f32"] = mod["qmatmul"].F32_LAUNCHES
    return counts
