"""Small CIFAR-style ResNet, the paper's vision workload, reduced (port of
``repro.models.resnet``).

The parameter tree is the reference's: convolution kernels in HWIO
``(k, k, c_in, c_out)``, ``stages`` a list per stage of block dicts, each
with a Python int ``stride``; images come in NHWC ``(B, H, W, 3)``. Inside,
activations run NCHW, as ``torch.nn.functional.conv2d`` takes them.

Convolutions follow the FMAC model: the compute-dtype inputs, upcast
(exactly) to f32, convolve with an f32 result, rounded once by
``qa.cast``; a 16-bit ``conv2d`` would round inside the library. The
package turns cuDNN's TF32 off, so the f32 convolution is f32. Padding
is XLA's "SAME": the total ``max((out − 1)·s + k − n, 0)``, its smaller half
before, so a 3×3 stride-2 convolution on 32×32 pads (0, 1) on each
spatial axis and a 1×1 stride-2 one pads nothing; ``padding=1`` would
pad (1, 1) and shift every output. BatchNorm runs in training mode with
population statistics (ddof 0) in f32, one fused op (paper footnote 4).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.qarith import QArith

__all__ = ["resnet_init", "resnet_apply", "split_strides", "join_strides",
           "RESNET_CIFAR_SMALL"]

RESNET_CIFAR_SMALL = dict(widths=(16, 32, 64), blocks_per_stage=1, classes=10)


def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * std).to(dtype)


def _conv_init(gen: torch.Generator, k: int, c_in: int, c_out: int, dtype):
    return _normal(gen, (k, k, c_in, c_out), math.sqrt(2.0 / (k * k * c_in)), dtype)


def _bn_init(c: int, dtype, device):
    return {"scale": torch.ones((c,), dtype=dtype, device=device),
            "bias": torch.zeros((c,), dtype=dtype, device=device)}


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(qa: QArith, w, x, stride: int = 1):
    """x (B,C,H,W), w HWIO → (B,C_out,H',W') in the compute dtype."""
    k = w.shape[0]
    (top, bottom), (left, right) = (_same_pad(n, k, stride) for n in x.shape[2:])
    xp = F.pad(qa.cast(x).to(torch.float32), (left, right, top, bottom))
    y = F.conv2d(xp, qa.cast(w).to(torch.float32).permute(3, 2, 0, 1), stride=stride)
    return qa.cast(y)


def _bn(qa: QArith, p, x):
    def f(xf, s, b):
        mu = xf.mean(dim=(0, 2, 3), keepdim=True)
        var = xf.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
        return (xf - mu) * torch.rsqrt(var + 1e-5) * s[:, None, None] + b[:, None, None]
    return qa.act(f, x, p["scale"], p["bias"])


def resnet_init(gen: torch.Generator, cfg: dict, dtype=torch.float32):
    """Parameters drawn from ``gen`` (a ``torch.Generator``, on its device):
    the reference's shapes and scales, the port's own draws."""
    dev = gen.device
    widths, nb = cfg["widths"], cfg["blocks_per_stage"]
    params = {"stem": _conv_init(gen, 3, 3, widths[0], dtype),
              "stem_bn": _bn_init(widths[0], dtype, dev), "stages": []}
    c_in = widths[0]
    for si, w in enumerate(widths):
        stage = []
        for bi in range(nb):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk = {"conv1": _conv_init(gen, 3, c_in, w, dtype), "bn1": _bn_init(w, dtype, dev),
                   "conv2": _conv_init(gen, 3, w, w, dtype), "bn2": _bn_init(w, dtype, dev)}
            if stride != 1 or c_in != w:
                blk["proj"] = _conv_init(gen, 1, c_in, w, dtype)
            blk["stride"] = stride
            stage.append(blk)
            c_in = w
        params["stages"].append(stage)
    params["head"] = {"kernel": _normal(gen, (c_in, cfg["classes"]), 1 / math.sqrt(c_in),
                                        dtype),
                      "bias": torch.zeros((cfg["classes"],), dtype=dtype, device=dev)}
    return params


def resnet_apply(qa: QArith, params, x):
    """x: (B,H,W,3) f32 images → f32 logits (B, classes)."""
    h = qa.cast(x).permute(0, 3, 1, 2)
    h = _bn(qa, params["stem_bn"], _conv(qa, params["stem"], h))
    h = qa.act(F.relu, h)
    for stage in params["stages"]:
        for blk in stage:
            stride = blk["stride"]
            y = _conv(qa, blk["conv1"], h, stride)
            y = qa.act(F.relu, _bn(qa, blk["bn1"], y))
            y = _bn(qa, blk["bn2"], _conv(qa, blk["conv2"], y))
            sc = _conv(qa, blk["proj"], h, stride) if "proj" in blk else h
            h = qa.act(F.relu, qa.add(y, sc))
    pooled = qa.act(lambda v: v.mean(dim=(2, 3)), h)
    logits = torch.matmul(pooled.to(torch.float32),
                          params["head"]["kernel"].to(torch.float32))
    return logits + params["head"]["bias"].to(torch.float32)


def split_strides(params):
    """(the tree of float leaves, the strides): what an optimizer or
    autograd takes, sharing the tensors, and the ints it cannot."""
    floats = {k: v for k, v in params.items() if k != "stages"}
    floats["stages"] = [[{k: v for k, v in blk.items() if k != "stride"} for blk in stage]
                        for stage in params["stages"]]
    return floats, [[blk["stride"] for blk in stage] for stage in params["stages"]]


def join_strides(floats, strides):
    """The inverse of :func:`split_strides`: a tree ``resnet_apply`` takes."""
    out = dict(floats)
    out["stages"] = [[{**blk, "stride": s} for blk, s in zip(stage, ss)]
                     for stage, ss in zip(floats["stages"], strides)]
    return out
