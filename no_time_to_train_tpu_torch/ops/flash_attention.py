"""Flash attention (port of `no_time_to_train_tpu/ops/flash_attention.py`):
the encoders' `flash_sdpa_bnhd` and `flash_sdpa_window_qkv`, and the two
entries the SAM2 memory attention takes, `flash_sdpa` and
`flash_sdpa_masked`.

`flash_sdpa_bnhd` is single-softmax attention on the [B, N, H, D] layout a
qkv projection produces (DINOv2 / DINOv3 layers, Hiera global blocks);
`flash_sdpa_window_qkv` is window-local attention straight off a packed qkv
[B, N, 3C] (Hiera windowed blocks). Both compute what the Pallas kernels'
`_softmax_attend` computes: float32 logits, the 1/sqrt(D) scale folded into
the shifted exponent, the normalized weights cast to v's dtype before the
float32-accumulated value product.

On a CUDA tensor each launches its kernel (`csrc/onepass_attn.cu`,
`csrc/window_attn.cu`, all four entries on the tile of
`csrc/attn_tile.cuh`); on a CPU tensor, or inside `no_fusion()`, each runs
its plain version (`onepass_bnhd_plain`, `window_qkv_plain`). The kernels
stream key tiles with an online softmax, so they round the unnormalized
weights to bf16 and divide by the sum after the value product; the plain
versions keep the TPU kernel's order (normalize, then round). The two agree
within the bf16 band stated where they are compared.

`flash_sdpa` is unmasked attention on [..., H, N, D] (the memory
attention's self-attention at D = 256; the JAX package's `_onepass_bh` and
`_flash_bh` in one kernel, `csrc/flash_bh.cu`); `flash_sdpa_masked` adds a
per-batch key-column mask (the memory cross-attention over the ring-masked
memory bank, `csrc/flash_masked.cu`). Their plain versions are
`flash_bh_plain` and `flash_masked_plain`.
"""
import ctypes
import math

import torch

from no_time_to_train_tpu_torch.ops import _cuda
from no_time_to_train_tpu_torch.ops.upscale_product import fusion_disabled

__all__ = ["ONEPASS_MAX_NK", "MASKED_NEG", "flash_sdpa_bnhd",
           "flash_sdpa_window_qkv", "flash_sdpa", "flash_sdpa_masked",
           "onepass_bnhd_plain", "window_qkv_plain", "flash_bh_plain",
           "flash_masked_plain", "LAUNCHES"]

# widest key range (padded to 128) the TPU's single-pass kernels take: the
# gate of `flash_sdpa_bnhd`, and the least masked key range that the JAX
# package sends to `flash_sdpa_masked`
ONEPASS_MAX_NK = 4608
_MAX_D = 256          # the shared tile of the four kernels
# the additive bias of a masked key, as the TPU kernel's
MASKED_NEG = -1e30

LAUNCHES = {"flash_sdpa_bnhd": 0, "flash_sdpa_window_qkv": 0,
            "flash_sdpa": 0, "flash_sdpa_masked": 0}


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


def flash_bh_plain(q, k, v):
    """q [..., H, Nq, D], k / v [..., H, Nk, D] -> [..., H, Nq, D] in q's
    dtype, with the TPU single-pass kernel's cast points."""
    s = q.float() @ k.float().transpose(-1, -2)
    p = _softmax_attend(s, v.dtype, 1.0 / math.sqrt(q.shape[-1]))
    return (p.float() @ v.float()).to(q.dtype)


def flash_masked_plain(q, k, v, key_valid):
    """q [B, H, Nq, D], k / v [B, H, Nk, D], key_valid [B, Nk] bool (True =
    attend) -> [B, H, Nq, D]. The TPU streaming kernel's arithmetic with one
    maximum over the whole key range: float32 logits * scale + bias (0 /
    -1e30), the unnormalized weights cast to v's dtype, the float32 value
    product divided by the float32 sum. A row with no valid key has equal
    logits everywhere and returns the mean of v."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = q.float() @ k.float().transpose(-1, -2) * scale
    s = s + _key_bias(key_valid)[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = p.to(v.dtype).float() @ v.float()
    return (o / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def _key_bias(key_valid):
    zero = torch.zeros((), dtype=torch.float32, device=key_valid.device)
    return torch.where(key_valid, zero, zero + MASKED_NEG)


def _flash_operand(x, name):
    """[B, H, N, D] with unit stride in D and rows that start on 16-byte
    boundaries; a view that is not so is copied."""
    grain = 16 // x.element_size()
    if x.stride(3) != 1 or any(x.stride(i) % grain for i in range(3)):
        x = x.contiguous()
    _cuda.require(x.is_cuda and x.data_ptr() % 16 == 0,
                  f"{name}: a 16-byte aligned CUDA tensor")
    return x


def _launch_flash(name, q, k, v, bias):
    req = _cuda.require
    req(q.dim() >= 3 and k.dim() == q.dim() and v.dim() == q.dim(),
        "q [..., H, Nq, D], k / v [..., H, Nk, D]")
    lead, (h, nq, d) = q.shape[:-3], q.shape[-3:]
    nk = k.shape[-2]
    req(k.shape == lead + (h, nk, d) and v.shape == k.shape,
        "q [..., H, Nq, D], k / v [..., H, Nk, D]")
    req(k.dtype == q.dtype and v.dtype == q.dtype, "q, k, v share one dtype")
    req(q.dtype in (torch.float32, torch.bfloat16),
        f"kernels take float32 or bfloat16, got {q.dtype}")
    req(d % (16 // q.element_size()) == 0 and d <= _MAX_D,
        f"head dim {d}: the kernels take D <= {_MAX_D} in whole "
        "16-byte pieces")
    b = math.prod(lead)
    req(b >= 1 and nq >= 1 and nk >= 1 and b * h <= 65535,
        "at least one query and key, at most 65535 (batch, head) slices")
    q4, k4, v4 = (_flash_operand(x.reshape(b, h, n, d), nm)
                  for x, n, nm in ((q, nq, "q"), (k, nk, "k"), (v, nk, "v")))
    strides = (ctypes.c_longlong * 9)(
        *(x.stride(i) for x in (q4, k4, v4) for i in range(3)))
    out = torch.empty((b, h, nq, d), dtype=q.dtype, device=q.device)
    tail = (strides, b, h, nq, nk, d, 1.0 / math.sqrt(d),
            _cuda.dtype_code(q.dtype), _cuda.stream_ptr(q.device))
    if bias is None:
        err = _cuda.lib().nttt_flash_bh(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
            *tail)
    else:
        err = _cuda.lib().nttt_flash_masked(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), bias.data_ptr(),
            out.data_ptr(), *tail)
    _cuda.check(err, f"nttt_{name}")
    return out.reshape(lead + (h, nq, d))


def flash_sdpa(q, k, v):
    """Kernels 11 and 12 as one: unmasked attention over [..., H, N, D]
    operands and result, any key count, D <= 256. Strided views with unit
    stride in D and 16-byte aligned rows are read in place."""
    if q.device.type == "cpu" or fusion_disabled():
        return flash_bh_plain(q, k, v)
    out = _launch_flash("flash_bh", q, k, v, None)
    LAUNCHES["flash_sdpa"] += 1
    return out


def flash_sdpa_masked(q, k, v, key_valid):
    """Kernel 13: attention over q [B, H, Nq, D], k / v [B, H, Nk, D] with a
    per-batch key-column mask key_valid [B, Nk] (bool, True = attend) shared
    by the heads. A row with no valid key returns the mean of v."""
    _cuda.require(q.dim() == 4 and key_valid.dtype == torch.bool
                  and key_valid.shape == (q.shape[0], k.shape[-2]),
                  "q [B, H, Nq, D] and key_valid [B, Nk] bool")
    if q.device.type == "cpu" or fusion_disabled():
        return flash_masked_plain(q, k, v, key_valid)
    _cuda.require(key_valid.device == q.device, "key_valid on q's device")
    out = _launch_flash("flash_masked", q, k, v,
                        _key_bias(key_valid).contiguous())
    LAUNCHES["flash_sdpa_masked"] += 1
    return out
