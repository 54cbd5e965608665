"""Flash attention for the encoders (port of the `flash_sdpa_bnhd` and
`flash_sdpa_window_qkv` entries of `no_time_to_train_tpu/ops/flash_attention.py`).

`flash_sdpa_bnhd` is single-softmax attention on the [B, N, H, D] layout a
qkv projection produces (DINOv2 / DINOv3 layers, Hiera global blocks);
`flash_sdpa_window_qkv` is window-local attention straight off a packed qkv
[B, N, 3C] (Hiera windowed blocks). Both compute what the Pallas kernels'
`_softmax_attend` computes: float32 logits, the 1/sqrt(D) scale folded into
the shifted exponent, the normalized weights cast to v's dtype before the
float32-accumulated value product.

On a CUDA tensor each launches its kernel (`csrc/onepass_attn.cu`,
`csrc/window_attn.cu`); on a CPU tensor, or inside `no_fusion()`, each runs
its plain version (`onepass_bnhd_plain`, `window_qkv_plain`). The kernels
stream key tiles with an online softmax, so they round the unnormalized
weights to bf16 and divide by the sum after the value product; the plain
versions keep the TPU kernel's order (normalize, then round). The two agree
within the bf16 band stated where they are compared.
"""
import math

import torch

from no_time_to_train_tpu_torch.ops import _cuda
from no_time_to_train_tpu_torch.ops.upscale_product import fusion_disabled

__all__ = ["ONEPASS_MAX_NK", "flash_sdpa_bnhd", "flash_sdpa_window_qkv",
           "onepass_bnhd_plain", "window_qkv_plain", "LAUNCHES"]

# widest key range (padded to 128) the TPU's single-pass kernel takes; wider
# unmasked ranges go to its online kernels, which are not ported (ROADMAP B.8)
ONEPASS_MAX_NK = 4608
_MAX_D = 128

LAUNCHES = {"flash_sdpa_bnhd": 0, "flash_sdpa_window_qkv": 0}


def _softmax_attend(s, v_dtype, scale):
    """float32 logits [..., Nq, Nk] -> bf16/f32 weights, as the TPU kernel
    rounds them: exp((s - max) * scale) / sum, cast to v's dtype."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp((s - m) * scale)
    return (p / p.sum(dim=-1, keepdim=True)).to(v_dtype)


def onepass_bnhd_plain(q, k, v):
    """q [B, Nq, H, D], k / v [B, Nk, H, D] -> [B, Nq, H, D] in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = _softmax_attend(s, v.dtype, scale)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def window_qkv_plain(qkv, heads, win):
    """qkv [B, N, 3C] with N a multiple of `win`, tokens window-major: each
    run of `win` tokens attends only within itself. Returns [B, N, C]."""
    b, n, c3 = qkv.shape
    _check_window(n, c3, heads, win)
    c = c3 // 3
    d = c // heads
    x = qkv.reshape(b, n // win, win, 3, heads, d)
    q, k, v = x.unbind(3)                          # [B, nw, win, H, D]
    s = torch.einsum("bwqhd,bwkhd->bwhqk", q.float(), k.float())
    p = _softmax_attend(s, qkv.dtype, 1.0 / math.sqrt(d))
    o = torch.einsum("bwhqk,bwkhd->bwqhd", p.float(), v.float())
    return o.to(qkv.dtype).reshape(b, n, c)


def _check_window(n, c3, heads, win):
    _cuda.require(win >= 1 and n % win == 0,
                  f"{n} tokens do not split into windows of {win}")
    _cuda.require(c3 % 3 == 0 and (c3 // 3) % heads == 0,
                  f"packed width {c3} does not split into 3 x {heads} heads")


def _check_operand(x, name, d):
    """The kernel reads 16-byte pieces of rows whose heads sit side by side:
    unit element stride, head stride D, 16-byte aligned rows."""
    grain = 16 // x.element_size()
    _cuda.require(x.is_cuda and x.stride(3) == 1 and x.stride(2) == d,
                  f"{name}: CUDA tensor with [.., H, D] rows contiguous")
    _cuda.require(x.data_ptr() % 16 == 0 and x.stride(1) % grain == 0
                  and x.stride(0) % grain == 0,
                  f"{name}: rows must start on 16-byte boundaries")


def _check_dtype_d(x, d):
    _cuda.require(x.dtype in (torch.float32, torch.bfloat16),
                  f"kernels take float32 or bfloat16, got {x.dtype}")
    _cuda.require(d % (16 // x.element_size()) == 0 and d <= _MAX_D,
                  f"head dim {d}: the kernels take D <= {_MAX_D} in whole "
                  "16-byte pieces")


def flash_sdpa_bnhd(q, k, v):
    """Kernel 9: attention over [B, N, H, D] operands and result. q, k, v
    may be strided views (a packed qkv's columns) as long as each row's
    [H, D] block is contiguous and 16-byte aligned."""
    if q.device.type == "cpu" or fusion_disabled():
        return onepass_bnhd_plain(q, k, v)
    req = _cuda.require
    req(q.dim() == 4 and k.dim() == 4, "q [B, Nq, H, D], k / v [B, Nk, H, D]")
    b, nq, h, d = q.shape
    nk = k.shape[1]
    req(k.shape == (b, nk, h, d) and v.shape == k.shape,
        "q [B, Nq, H, D], k / v [B, Nk, H, D]")
    req(k.dtype == q.dtype and v.dtype == q.dtype, "q, k, v share one dtype")
    _check_dtype_d(q, d)
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(x, name, d)
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    err = _cuda.lib().nttt_onepass_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.stride(0), k.stride(0), v.stride(0),
        q.stride(1), k.stride(1), v.stride(1),
        b, nq, nk, h, d, 1.0 / math.sqrt(d), _cuda.dtype_code(q.dtype),
        _cuda.stream_ptr(q.device))
    _cuda.check(err, "nttt_onepass_attn")
    LAUNCHES["flash_sdpa_bnhd"] += 1
    return out


def flash_sdpa_window_qkv(qkv, heads, win):
    """Kernel 10: window-local attention on a packed qkv [B, N, 3C]
    (window-major tokens, N a multiple of `win`). Returns [B, N, C]."""
    if qkv.device.type == "cpu" or fusion_disabled():
        return window_qkv_plain(qkv, heads, win)
    req = _cuda.require
    req(qkv.dim() == 3, "qkv [B, N, 3C]")
    b, n, c3 = qkv.shape
    _check_window(n, c3, heads, win)
    c = c3 // 3
    d = c // heads
    _check_dtype_d(qkv, d)
    req(qkv.is_cuda and qkv.is_contiguous() and qkv.data_ptr() % 16 == 0,
        "qkv must be a contiguous, 16-byte aligned CUDA tensor")
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    err = _cuda.lib().nttt_window_attn(
        qkv.data_ptr(), out.data_ptr(), b, n, c, heads, win,
        1.0 / math.sqrt(d), _cuda.dtype_code(qkv.dtype),
        _cuda.stream_ptr(qkv.device))
    _cuda.check(err, "nttt_window_attn")
    LAUNCHES["flash_sdpa_window_qkv"] += 1
    return out
