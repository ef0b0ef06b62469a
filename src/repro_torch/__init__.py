"""PyTorch + CUDA port of the ``repro`` reproduction, for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package mirrors its
subpackage layout (``core``, ``configs``, ``models``, ``kernels``,
``optim``, ``data``, ``serve``, ``train``, ``dist``, ``launch``) so each
module's counterpart is found by path. It imports ``torch`` and numpy
only — never ``jax`` or ``repro``. Ported so far: serving (continuous
batching over contiguous or paged KV pools, greedy or sampled) and
training with the paper's SR and Kahan optimizers, for every model of the
reference, on one device or data-parallel across processes with the fp32
or SR-compressed gradient wires; the paper's experiments; every TPU
kernel, by hand for Hopper; see ROADMAP.md.

Matmul numerics, set once here for the whole package: the FMAC model
(16-bit inputs, f32 accumulation, one output rounding) forbids cuBLAS's
reduced-precision bf16/fp16 reductions, and f32 products must run in
full f32 rather than TF32: cuBLAS's products and cuDNN's convolutions
(the ResNet's f32 convolutions; cuDNN's default is TF32).
"""
import torch

torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

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
