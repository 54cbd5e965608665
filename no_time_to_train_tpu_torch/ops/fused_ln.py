"""Row LayerNorm kernel for the bf16 encoder and decoder norms (port of
`no_time_to_train_tpu/ops/fused_ln.py`).

`layer_norm` normalizes the last axis with float32 statistics and the
compute-dtype normalize and affine of `models/sam2/common._layer_norm`. On a
CUDA tensor it launches the kernel in `csrc/layer_norm.cu` (bf16: the
row-slab kernel; float32: one warp a row); on a CPU tensor, or inside
`no_fusion()`, it runs `layer_norm_plain`. `layer_norm_warp` runs the
one-warp-a-row kernel for either dtype: a second implementation to check
and time the bf16 kernel against, called by no model.
"""
import math

import torch

from no_time_to_train_tpu_torch.ops import _cuda
from no_time_to_train_tpu_torch.ops.upscale_product import fusion_disabled

__all__ = ["ln_fusible", "layer_norm", "layer_norm_plain",
           "layer_norm_warp", "LAUNCHES"]

LAUNCHES = {"layer_norm": 0}
_MAX_COLS = 2048


def ln_fusible(x, min_rows=1024):
    """True when the kernel applies: bf16, at least `min_rows` rows and
    16 <= C, outside no_fusion(). (The TPU kernel's rows % 8 rule was a
    sublane constraint and does not apply here.)"""
    if x.dim() < 2 or x.dtype != torch.bfloat16 or fusion_disabled():
        return False
    rows = math.prod(x.shape[:-1])
    return rows >= min_rows and x.shape[-1] >= 16


def layer_norm_plain(x, weight, bias, eps):
    """`_layer_norm`'s formulation: float32 statistics; in float32 the whole
    normalize, otherwise the normalize and affine in x's dtype with a
    rounding after every operation."""
    dt = x.dtype
    xf = x.float()
    u = xf.mean(-1, keepdim=True)
    s = (xf - u).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(s + eps)
    if dt == torch.float32:
        return (xf - u) * inv * weight.float() + bias.float()
    y = (x - u.to(dt)) * inv.to(dt)
    return y * weight.to(dt) + bias.to(dt)


def _launch(name, x, weight, bias, eps):
    req = _cuda.require
    c = x.shape[-1]
    req(x.is_cuda and x.is_contiguous(), "x must be a contiguous CUDA tensor")
    req(1 <= c <= _MAX_COLS, f"layer_norm kernel takes C <= {_MAX_COLS}")
    req(weight.shape == (c,) and bias.shape == (c,), "weight/bias shape")
    rows = math.prod(x.shape[:-1])
    w = weight.to(device=x.device, dtype=x.dtype).contiguous()
    b = bias.to(device=x.device, dtype=x.dtype).contiguous()
    out = torch.empty_like(x)
    err = getattr(_cuda.lib(), name)(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), rows, c,
        float(eps), _cuda.dtype_code(x.dtype), _cuda.stream_ptr(x.device))
    _cuda.check(err, name)
    return out


def layer_norm(x, weight, bias, eps):
    """Kernel K1 over the last axis of x (any leading shape)."""
    if x.device.type == "cpu" or fusion_disabled():
        return layer_norm_plain(x, weight, bias, eps)
    _cuda.no_grad_operands("layer_norm", x, weight, bias)
    out = _launch("nttt_layer_norm", x, weight, bias, eps)
    _cuda.count(LAUNCHES, "layer_norm")
    return out


def layer_norm_warp(x, weight, bias, eps):
    """`layer_norm` on the one-warp-a-row kernel for either dtype (CUDA
    tensors only): a second implementation to check and time the bf16
    kernel against. It counts no launch."""
    return _launch("nttt_layer_norm_warp", x, weight, bias, eps)
