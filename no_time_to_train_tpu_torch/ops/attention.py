"""Plain scaled dot-product attention (port of the `attention_impl: xla`
path of `no_time_to_train_tpu/ops/attention.py`).

Both entry points mirror `_xla_sdpa`: logits in the operands' dtype scaled
by 1/sqrt(D) computed in that dtype, softmax in float32, probabilities cast
back before the value product. They use matmul and softmax, not
`F.scaled_dot_product_attention`. The flash-attention kernels that serve
`attention_impl: pallas` on the TPU are not ported yet.
"""
from functools import lru_cache

import torch

__all__ = ["sdpa", "sdpa_bnhd", "check_attention_impl"]


def check_attention_impl(impl, device):
    """`attention_impl` is "xla" or "pallas"; "pallas" runs the plain path on
    the CPU, as the JAX package does there, and is refused on CUDA."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"attention_impl must be 'xla' or 'pallas', got {impl!r}")
    if impl == "pallas" and torch.device(device).type == "cuda":
        raise NotImplementedError(
            "attention_impl='pallas' needs the encoder flash-attention kernels "
            "(ROADMAP B.2 flash_sdpa_bnhd, B.3 flash_sdpa_window_qkv), which "
            "are not ported to CUDA yet; use attention_impl='xla'")


@lru_cache(maxsize=None)
def _scale(d, dtype):
    """1 / sqrt(d) computed in `dtype`, as a Python float (exact in dtype)."""
    return float(1.0 / torch.sqrt(torch.tensor(d, dtype=dtype)))


def sdpa(q, k, v, mask=None):
    """Attention over [..., heads, N, D]; `mask` broadcasts to
    [..., heads, Nq, Nk] with True = attend."""
    logits = (q @ k.transpose(-1, -2)) * _scale(q.shape[-1], q.dtype)
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return probs @ v


def sdpa_bnhd(q, k, v):
    """Attention with [..., N, heads, D] operands and result."""
    out = sdpa(q.transpose(-3, -2), k.transpose(-3, -2), v.transpose(-3, -2))
    return out.transpose(-3, -2)
