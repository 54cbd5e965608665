"""Torch-parity separable resize as two matrix products.

Port of `no_time_to_train_tpu/ops/resize.py`. The weight matrices are built in
float64 numpy (`_resize_matrix_np`, framework-free) and match
`F.interpolate(align_corners=False)` for bicubic (a = -0.75), bilinear (with
or without antialias) and nearest. Expressing the resize as
`W_h @ x @ W_w^T` keeps every flavour exact, including PIL-style antialias on
downscale, which `F.interpolate` has only for some modes.
"""
from functools import lru_cache

import numpy as np
import torch

from no_time_to_train_tpu_torch.ops.graph_inputs import held

__all__ = ["resize", "resize_hw", "resize_matrix", "_resize_matrix_np"]


def _kernel_bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _kernel_bicubic(x, a=-0.75):
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


_KERNELS = {
    "bilinear": (_kernel_bilinear, 1.0),
    "bicubic": (_kernel_bicubic, 2.0),
}


@lru_cache(maxsize=None)
def _resize_matrix_np(in_size: int, out_size: int, mode: str, antialias: bool):
    """[out_size, in_size] float64 weight matrix matching torch F.interpolate."""
    if mode == "nearest":
        # torch nearest: src = floor(dst * in/out)
        w = np.zeros((out_size, in_size))
        idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
        idx = np.clip(idx, 0, in_size - 1)
        w[np.arange(out_size), idx] = 1.0
        return w

    kernel, support = _KERNELS[mode]
    scale = in_size / out_size
    use_aa = antialias and scale > 1.0
    fscale = scale if use_aa else 1.0
    ksupport = support * fscale

    w = np.zeros((out_size, in_size))
    for i in range(out_size):
        center = (i + 0.5) * scale - 0.5
        lo = int(np.floor(center - ksupport)) + 1
        hi = int(np.ceil(center + ksupport)) + 1
        ks = np.arange(lo, hi)
        weights = kernel((ks - center) / fscale) / fscale
        if use_aa:
            # PIL/torch antialias: window clipped to the valid range, renormalized
            valid = (ks >= 0) & (ks < in_size)
            ks, weights = ks[valid], weights[valid]
            s = weights.sum()
            if s > 0:
                weights = weights / s
            np.add.at(w[i], ks, weights)
        else:
            # torch without antialias: replicate-clamp source indices
            ks = np.clip(ks, 0, in_size - 1)
            np.add.at(w[i], ks, weights)
    return w


@lru_cache(maxsize=64)
def _resize_matrix_tensor(in_size, out_size, mode, antialias, dtype, device):
    return torch.as_tensor(_resize_matrix_np(in_size, out_size, mode, antialias),
                           dtype=dtype, device=device)


def resize_matrix(in_size, out_size, mode="bilinear", antialias=False,
                  dtype=torch.float32, device="cpu"):
    """[out_size, in_size] weights on `device`, built once per shape (the
    caller must not modify the shared tensor)."""
    return held(_resize_matrix_tensor(in_size, out_size, mode,
                                      bool(antialias), dtype,
                                      torch.device(device)))


def resize(x, out_hw, mode="bilinear", antialias=False):
    """Resize axes (-3, -2) of a [..., H, W, C] tensor to `out_hw`.

    Floating inputs below float32 are computed in float32 and cast back, as
    the JAX package does."""
    h, w = x.shape[-3], x.shape[-2]
    out_h, out_w = out_hw
    cdt = x.dtype if x.dtype in (torch.float32, torch.float64) else torch.float32
    y = x.to(cdt)
    if h != out_h:
        wh = resize_matrix(h, out_h, mode, antialias, cdt, x.device)
        y = torch.einsum("oh,...hwc->...owc", wh, y)
    if w != out_w:
        ww = resize_matrix(w, out_w, mode, antialias, cdt, x.device)
        y = torch.einsum("ow,...hwc->...hoc", ww, y)
    return y.to(x.dtype) if x.is_floating_point() else y


def resize_hw(x, out_hw, mode="bilinear", antialias=False):
    """Resize the last two dims of [..., H, W] (mask and logit stacks)."""
    return resize(x[..., None], out_hw, mode=mode, antialias=antialias)[..., 0]
