"""PyTorch + CUDA port of the ``repro`` reproduction, for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package mirrors its
subpackage layout (``core``, ``configs``, ``models``, ``kernels``,
``optim``, ``data``, ``serve``, ``train``, ``launch``) so each module's counterpart is found
by path. It imports ``torch`` and numpy only — never ``jax`` or
``repro``. The slices ported so far: continuous-batching greedy serving
of dense decoder-only LMs over the contiguous KV pool, and single-device
pure-bf16 training with the paper's SR and Kahan optimizers (``optim``,
``train``, ``data``, ``launch.train``); see ROADMAP.md.

Matmul numerics, set once here for the whole package: the FMAC model
(16-bit inputs, f32 accumulation, one output rounding) forbids cuBLAS's
reduced-precision bf16/fp16 reductions, and f32 products must run in
full f32 rather than TF32.
"""
import torch

torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_tf32 = False

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names the
    CPU. Never falls back: asking for CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA unless told otherwise, and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev
