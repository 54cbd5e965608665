"""Scaled dot-product attention and its routing (port of
`no_time_to_train_tpu/ops/attention.py`).

`sdpa` and `sdpa_bnhd` under `attention_impl="xla"` mirror `_xla_sdpa`:
logits in the operands' dtype scaled by 1/sqrt(D) computed in that dtype,
softmax in float32, probabilities cast back before the value product. They
use matmul and softmax, not `F.scaled_dot_product_attention`.

Under `attention_impl="pallas"` long attentions take the flash kernels of
`ops/flash_attention.py` where the JAX package's gates open (its CPU / TPU
device checks aside), both sequences being at least 512 tokens:
`sdpa_bnhd` takes `flash_sdpa_bnhd` for 4-D operands whose key range fits
the TPU's single-pass kernel, and otherwise transposes into `sdpa`; `sdpa`
takes `flash_sdpa` for unmasked keys up to the TPU's resident range of
12288, and `flash_sdpa_masked` for 4-D operands under a bool key-column
mask [B, 1, 1, Nk] over more than 4608 keys (the SAM2 memory
cross-attention); `window_sdpa_qkv` serves Hiera's windowed blocks. Every
other shape, and every route inside `no_fusion()`, is the plain formula.

The impl is carried per model: each attention module holds an
`attention_impl` attribute, which `set_attention_impl` sets on a model.
"""
from functools import lru_cache

import torch

from no_time_to_train_tpu_torch.ops.flash_attention import (
    ONEPASS_MAX_NK, flash_sdpa, flash_sdpa_bnhd, flash_sdpa_masked,
    flash_sdpa_window_qkv)
from no_time_to_train_tpu_torch.ops.upscale_product import fusion_disabled

__all__ = ["sdpa", "sdpa_bnhd", "window_sdpa_qkv", "check_attention_impl",
           "set_attention_impl"]

_IMPLS = ("xla", "pallas")
_PALLAS_MIN_Q = 512   # the JAX package's gate: shorter sequences stay plain
_RESIDENT_MAX_NK = 12288   # wider key ranges stay plain in the JAX package


def check_attention_impl(impl):
    """`attention_impl` is "xla" or "pallas", on any device (on the CPU the
    kernels' plain versions run)."""
    if impl not in _IMPLS:
        raise ValueError(f"attention_impl must be 'xla' or 'pallas', got {impl!r}")


def set_attention_impl(model, impl):
    """Set `impl` on every attention module of `model`; returns `model`."""
    check_attention_impl(impl)
    for mod in model.modules():
        if hasattr(mod, "attention_impl"):
            mod.attention_impl = impl
    return model


@lru_cache(maxsize=None)
def _scale(d, dtype):
    """1 / sqrt(d) computed in `dtype`, as a Python float (exact in dtype)."""
    return float(1.0 / torch.sqrt(torch.tensor(d, dtype=dtype)))


def _padded(n):
    return (n + 127) // 128 * 128


def sdpa(q, k, v, mask=None, impl="xla"):
    """Attention over [..., heads, N, D]; `mask` broadcasts to
    [..., heads, Nq, Nk] with True = attend. The mask decoder calls it
    without an `impl`: one of its sides is at most 16 tokens, which never
    reaches the gates."""
    check_attention_impl(impl)
    if (impl == "pallas" and not fusion_disabled()
            and q.shape[-2] >= _PALLAS_MIN_Q and k.shape[-2] >= _PALLAS_MIN_Q):
        n_k = k.shape[-2]
        if mask is None:
            if _padded(n_k) <= _RESIDENT_MAX_NK:
                return flash_sdpa(q, k, v)
        elif (q.dim() == 4 and mask.dim() == 4 and n_k > ONEPASS_MAX_NK
                and mask.shape == (q.shape[0], 1, 1, n_k)
                and mask.dtype == torch.bool):
            return flash_sdpa_masked(q, k, v, mask[:, 0, 0, :])
    logits = (q @ k.transpose(-1, -2)) * _scale(q.shape[-1], q.dtype)
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return probs @ v


def sdpa_bnhd(q, k, v, impl):
    """Attention with [..., N, heads, D] operands and result."""
    check_attention_impl(impl)
    if (impl == "pallas" and not fusion_disabled() and q.dim() == 4
            and q.shape[-3] >= _PALLAS_MIN_Q and k.shape[-3] >= _PALLAS_MIN_Q
            and _padded(k.shape[-3]) <= ONEPASS_MAX_NK):
        return flash_sdpa_bnhd(q, k, v)
    out = sdpa(q.transpose(-3, -2), k.transpose(-3, -2), v.transpose(-3, -2),
               impl=impl)
    return out.transpose(-3, -2)


def window_sdpa_qkv(qkv, heads, win, impl, min_tokens=4096):
    """Window-local attention on a packed qkv [B, T, 3C] whose rows are
    windows of T = `win` tokens. Returns [B, T, C] from the window kernel,
    or None where the JAX package's gate stays shut (the caller then splits
    the heads and calls `sdpa_bnhd`)."""
    check_attention_impl(impl)
    b, t, c3 = qkv.shape
    if (impl != "pallas" or b * t < min_tokens or c3 % 3 or win != t
            or fusion_disabled()):
        return None
    out = flash_sdpa_window_qkv(qkv.reshape(1, b * t, c3), heads, win)
    return out.reshape(b, t, c3 // 3)
