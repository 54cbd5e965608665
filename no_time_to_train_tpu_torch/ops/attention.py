"""Scaled dot-product attention and its routing (port of
`no_time_to_train_tpu/ops/attention.py`).

`sdpa` and `sdpa_bnhd` under `attention_impl="xla"` mirror `_xla_sdpa`:
logits in the operands' dtype scaled by 1/sqrt(D) computed in that dtype,
softmax in float32, probabilities cast back before the value product. They
use matmul and softmax, not `F.scaled_dot_product_attention`.

Under `attention_impl="pallas"` the encoders' long attentions take the
flash kernels of `ops/flash_attention.py` where the JAX package's gates
open (its CPU / TPU device checks aside): `sdpa_bnhd` for both sequences of
at least 512 tokens and a key range that fits the single-pass kernel,
`window_sdpa_qkv` for Hiera's windowed blocks. Inside `no_fusion()` every
route is the plain formula. A shape that the JAX package would send to its
other flash kernels (`_onepass_bh`, `_flash_bh`: not 4-D, or keys past the
single-pass range) raises here; keys past the resident range of 12288 take
the plain formula there and here.

The impl is carried per model: each attention module holds an
`attention_impl` attribute, which `set_attention_impl` sets on a model.
"""
from functools import lru_cache

import torch

from no_time_to_train_tpu_torch.ops.flash_attention import (
    ONEPASS_MAX_NK, flash_sdpa_bnhd, flash_sdpa_window_qkv)
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


def sdpa(q, k, v, mask=None):
    """Attention over [..., heads, N, D]; `mask` broadcasts to
    [..., heads, Nq, Nk] with True = attend. The decoder's entry: its
    sequences never reach the JAX package's flash gates (one side is at most
    16 tokens), so it has no `impl`."""
    logits = (q @ k.transpose(-1, -2)) * _scale(q.shape[-1], q.dtype)
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return probs @ v


def sdpa_bnhd(q, k, v, impl):
    """Attention with [..., N, heads, D] operands and result."""
    check_attention_impl(impl)
    if (impl == "pallas" and not fusion_disabled()
            and q.shape[-3] >= _PALLAS_MIN_Q and k.shape[-3] >= _PALLAS_MIN_Q):
        n_k_padded = (k.shape[-3] + 127) // 128 * 128
        if q.dim() == 4 and n_k_padded <= ONEPASS_MAX_NK:
            return flash_sdpa_bnhd(q, k, v)
        if n_k_padded <= _RESIDENT_MAX_NK:
            raise NotImplementedError(
                f"attention_impl='pallas' on q {tuple(q.shape)}, k "
                f"{tuple(k.shape)}: the JAX package runs this on its flash "
                "kernels `_onepass_bh` / `_flash_bh`, which are not ported "
                "yet (ROADMAP B.8); use attention_impl='xla'")
    out = sdpa(q.transpose(-3, -2), k.transpose(-3, -2), v.transpose(-3, -2))
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
