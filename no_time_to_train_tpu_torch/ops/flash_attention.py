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

`flash_sdpa` is unmasked attention on [..., H, N, D] (the memory
attention's self-attention at D = 256; the JAX package's `_onepass_bh` and
`_flash_bh` in one kernel, `csrc/flash_bh.cu`); `flash_sdpa_masked` adds a
per-batch key-column mask (the memory cross-attention over the ring-masked
memory bank, `csrc/flash_masked.cu`).

On a CUDA tensor each launches its kernel; on a CPU tensor, or inside
`no_fusion()`, each runs its plain version (`onepass_bnhd_plain`,
`window_qkv_plain`, `flash_bh_plain`, `flash_masked_plain`). Which entry
runs on which tile:
  * all four entries on bf16 operands: the register-accumulator tiles of
    `csrc/attn_mma.cuh` (the online softmax on the accumulator registers of
    the products, operand tiles alone in shared memory): `wgmma` products
    where the head dim pads to 64, 128 or 256 columns (D <= 64, 81..256),
    `mma.sync` products where it pads to 80 (65..80: Hiera's 72). At
    D > 128, where one head leaves most SMs idle, `flash_sdpa`,
    `flash_sdpa_bnhd` and `flash_sdpa_masked` cut the keys into
    `key_splits(n_q, n_k, d)` runs of whole key tiles whose partial results
    a second kernel merges in a fixed order; `flash_bh_split_plain` and
    `flash_masked_split_plain` are that arithmetic in plain PyTorch.
  * `flash_sdpa_masked` on bf16 adds a pre-pass on the device that lists,
    per batch element, the 64-key tiles with a valid key
    (`masked_tile_list_plain`); the kernel walks that list and cuts its runs
    over it, so masked tiles cost nothing and an element's result depends on
    its own mask only. An element with no valid key takes every tile.
  * `flash_sdpa_window_qkv` on bf16: windows of whole 128-row blocks (256,
    4096 tokens) are batch elements of the kernel `flash_sdpa_bnhd` runs (at
    D = 72 a window's result equals that entry's on the same rows bit for
    bit); any other window length (64, 16, 196, 49) runs the tiles' window
    mode, blocks of 64 rows of the flat token run with a key range per row.
  * every entry on float32 operands: the tile of `csrc/attn_tile.cuh` (FMAs,
    logits and accumulators in shared memory). `flash_sdpa_wmma`,
    `flash_sdpa_bnhd_wmma`, `flash_sdpa_masked_wmma` and
    `flash_sdpa_window_qkv_wmma` run the entries on that tile for either
    dtype (WMMA products in bf16): a second implementation to check and
    time against, called by no model.
The kernels stream key tiles with an online softmax, so they round the
unnormalized weights to bf16 and divide by the sum after the value product;
the plain versions keep the TPU kernel's order (normalize, then round). The
two agree within the bf16 band stated where they are compared.
"""
import ctypes
import math

import torch

from no_time_to_train_tpu_torch.ops import _cuda
from no_time_to_train_tpu_torch.ops.upscale_product import fusion_disabled

__all__ = ["ONEPASS_MAX_NK", "MASKED_NEG", "MAX_SPLITS", "flash_sdpa_bnhd",
           "flash_sdpa_window_qkv", "flash_sdpa", "flash_sdpa_masked",
           "flash_sdpa_wmma", "flash_sdpa_bnhd_wmma",
           "flash_sdpa_masked_wmma", "flash_sdpa_window_qkv_wmma",
           "key_splits", "masked_tile_list", "onepass_bnhd_plain",
           "window_qkv_plain", "flash_bh_plain", "flash_bh_split_plain",
           "merge_splits_plain", "flash_masked_plain",
           "masked_tile_list_plain", "flash_masked_split_plain", "LAUNCHES"]

# widest key range (padded to 128) the TPU's single-pass kernels take: the
# gate of `flash_sdpa_bnhd`, and the least masked key range that the JAX
# package sends to `flash_sdpa_masked`
ONEPASS_MAX_NK = 4608
_MAX_D = 256          # the widest head dim of both tiles
# the register-accumulator tile (csrc/attn_mma.cuh): key rows of a tile, the
# query rows of a block at D > 128, the most key splits it takes, and the SMs
# of an H100
_TILE_BK = 64
_SPLIT_BQ = 128
MAX_SPLITS = 4
_SMS = 132
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
    _cuda.require(x.is_cuda and x.stride(3) == 1
                  and (x.shape[2] == 1 or x.stride(2) == d),
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


def key_splits(n_q, n_k, d):
    """Runs of whole key tiles that the bf16 kernels of `flash_sdpa`,
    `flash_sdpa_bnhd` and `flash_sdpa_masked` (over its taken tiles) cut the
    key range into. It depends on (n_q, n_k, d)
    only, never on batch or heads, so a batch element's result does not
    depend on its batch. Up to D = 128 the models bring 8 or 16 heads, whose
    blocks fill the card: one run. At D > 128 (the memory attention, one
    head) the query tiles of 128 rows are spread over the SMs with up to 4
    runs of at least 8 key tiles each."""
    if d <= 128:
        return 1
    q_tiles = -(-n_q // _SPLIT_BQ)
    k_tiles = -(-n_k // _TILE_BK)
    return max(1, min(4, _SMS // q_tiles, k_tiles // 8))


def _split_args(q, slices, nq, nk, d, splits):
    """(splits, scratch_o, scratch_ml) of one launch over `slices` (batch,
    head) pairs: the rule's split count unless the caller forces one, and
    the float32 scratch the split kernels write (none at one split, which
    is all that float32 operands take)."""
    if q.dtype != torch.bfloat16:
        _cuda.require(splits in (None, 1), "float32 operands take no key splits")
        splits = 1
    elif splits is None:
        splits = key_splits(nq, nk, d)
    _cuda.require(1 <= splits <= MAX_SPLITS,
                  f"1 to {MAX_SPLITS} key splits, got {splits}")
    if splits == 1:
        return 1, None, None
    part_o = torch.empty((slices * splits, nq, d), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((slices * splits, nq, 2), dtype=torch.float32,
                          device=q.device)
    return splits, part_o, part_ml


def _ptr(x):
    return None if x is None else x.data_ptr()


def _check_bnhd(q, k, v):
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
    return b, nq, nk, h, d


def _bnhd_args(q, k, v, out, b, nq, nk, h, d):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.stride(0), k.stride(0), v.stride(0),
            q.stride(1), k.stride(1), v.stride(1),
            b, nq, nk, h, d, 1.0 / math.sqrt(d), _cuda.dtype_code(q.dtype))


def flash_sdpa_bnhd(q, k, v, *, splits=None):
    """Kernel 9: attention over [B, N, H, D] operands and result. q, k, v
    may be strided views (a packed qkv's columns) as long as each row's
    [H, D] block is contiguous and 16-byte aligned. `splits` forces a number
    of key splits on the bf16 kernel (the checks cross the merge with it);
    the models leave it to `key_splits`."""
    if q.device.type == "cpu" or fusion_disabled():
        return onepass_bnhd_plain(q, k, v)
    _cuda.no_grad_operands("flash_sdpa_bnhd", q, k, v)
    b, nq, nk, h, d = _check_bnhd(q, k, v)
    splits, part_o, part_ml = _split_args(q, b * h, nq, nk, d, splits)
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    err = _cuda.lib().nttt_onepass_attn(
        *_bnhd_args(q, k, v, out, b, nq, nk, h, d), splits, _ptr(part_o),
        _ptr(part_ml), _cuda.stream_ptr(q.device))
    _cuda.check(err, "nttt_onepass_attn")
    _cuda.count(LAUNCHES, "flash_sdpa_bnhd")
    return out


def flash_sdpa_bnhd_wmma(q, k, v):
    """`flash_sdpa_bnhd` on the tile of `csrc/attn_tile.cuh` for either
    dtype (CUDA tensors only): a second implementation to check and time
    the bf16 kernel against. It counts no launch."""
    b, nq, nk, h, d = _check_bnhd(q, k, v)
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    err = _cuda.lib().nttt_onepass_attn_wmma(
        *_bnhd_args(q, k, v, out, b, nq, nk, h, d),
        _cuda.stream_ptr(q.device))
    _cuda.check(err, "nttt_onepass_attn_wmma")
    return out


def _launch_window(name, qkv, heads, win):
    req = _cuda.require
    req(qkv.dim() == 3, "qkv [B, N, 3C]")
    b, n, c3 = qkv.shape
    _check_window(n, c3, heads, win)
    c = c3 // 3
    d = c // heads
    _check_dtype_d(qkv, d)
    req(qkv.is_cuda and qkv.is_contiguous() and qkv.data_ptr() % 16 == 0,
        "qkv must be a contiguous, 16-byte aligned CUDA tensor")
    req(1 <= b <= 65535 and heads <= 65535,
        "at most 65535 batch elements and heads")
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    err = getattr(_cuda.lib(), name)(
        qkv.data_ptr(), out.data_ptr(), b, n, c, heads, win,
        1.0 / math.sqrt(d), _cuda.dtype_code(qkv.dtype),
        _cuda.stream_ptr(qkv.device))
    _cuda.check(err, name)
    return out


def flash_sdpa_window_qkv(qkv, heads, win):
    """Kernel 10: window-local attention on a packed qkv [B, N, 3C]
    (window-major tokens, N a multiple of `win`). Returns [B, N, C]. Any
    window length and any D <= 256 in whole 16-byte pieces; the module's
    docstring says which tile a bf16 call takes."""
    if qkv.device.type == "cpu" or fusion_disabled():
        return window_qkv_plain(qkv, heads, win)
    _cuda.no_grad_operands("flash_sdpa_window_qkv", qkv)
    out = _launch_window("nttt_window_attn", qkv, heads, win)
    _cuda.count(LAUNCHES, "flash_sdpa_window_qkv")
    return out


def flash_sdpa_window_qkv_wmma(qkv, heads, win):
    """`flash_sdpa_window_qkv` on the tile of `csrc/attn_tile.cuh` for
    either dtype (CUDA tensors only): a second implementation to check and
    time the bf16 kernel against. It counts no launch."""
    return _launch_window("nttt_window_attn_wmma", qkv, heads, win)


def flash_bh_plain(q, k, v):
    """q [..., H, Nq, D], k / v [..., H, Nk, D] -> [..., H, Nq, D] in q's
    dtype, with the TPU single-pass kernel's cast points."""
    s = q.float() @ k.float().transpose(-1, -2)
    p = _softmax_attend(s, v.dtype, 1.0 / math.sqrt(q.shape[-1]))
    return (p.float() @ v.float()).to(q.dtype)


def merge_splits_plain(parts):
    """Merge the partial results of key splits as the kernel's second pass
    does. `parts` is a list of (o, m, l): the unnormalised float32 value
    product [..., Nq, D] of a split, its row maximum in base-2 logits
    [..., Nq, 1] (-inf for a split that saw no key) and its row sum
    [..., Nq, 1]. Returns sum_s w_s o_s / sum_s w_s l_s with
    w_s = 2^(m_s - max_s m_s), the splits taken in order."""
    m = torch.stack([p[1] for p in parts]).amax(dim=0)
    num = torch.zeros_like(parts[0][0])
    den = torch.zeros_like(parts[0][2])
    for o, m_s, l_s in parts:
        w = torch.exp2(m_s - m)
        num = num + w * o
        den = den + w * l_s
    return num / den


def flash_bh_split_plain(q, k, v, splits, tile=_TILE_BK):
    """`flash_sdpa` as the bf16 kernel computes it with the key range cut
    into `splits` runs of whole `tile`-key tiles (the last runs may be short
    or empty): per run the base-2 logits' row maximum, the unnormalised
    weights cast to v's dtype for the value product, their float32 sum; then
    `merge_splits_plain`. q [..., H, Nq, D], k / v [..., H, Nk, D]."""
    nk = k.shape[-2]
    per = -(-(-(-nk // tile)) // splits)
    scale_log2 = math.log2(math.e) / math.sqrt(q.shape[-1])
    parts = []
    for s in range(splits):
        lo = min(s * per * tile, nk)
        hi = min(lo + per * tile, nk)
        t = q.float() @ k[..., lo:hi, :].float().transpose(-1, -2) * scale_log2
        if hi == lo:
            m = t.new_full(t.shape[:-1] + (1,), -math.inf)
            p = t
        else:
            m = t.amax(dim=-1, keepdim=True)
            p = torch.exp2(t - m)
        parts.append((p.to(v.dtype).float() @ v[..., lo:hi, :].float(), m,
                      p.sum(dim=-1, keepdim=True)))
    return merge_splits_plain(parts).to(q.dtype)


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


def masked_tile_list_plain(key_valid, tile=_TILE_BK):
    """What the bf16 kernel's pre-pass hands it. key_valid [B, Nk] bool ->
    (tiles [B, ceil(Nk / tile)] int32, count [B] int32): per batch element
    the `tile`-key tiles that hold a valid key, ascending, then -1; and how
    many they are. Count 0 says that no key is valid: the kernel then takes
    every tile (and ends as the mean of v)."""
    b, nk = key_valid.shape
    n_tiles = -(-nk // tile)
    padded = torch.zeros((b, n_tiles * tile), dtype=torch.bool,
                         device=key_valid.device)
    padded[:, :nk] = key_valid
    taken = padded.reshape(b, n_tiles, tile).any(dim=-1)
    index = torch.arange(n_tiles, device=key_valid.device).expand(b, -1)
    # taken tiles first, each group in ascending order
    order = torch.argsort((~taken).to(torch.int8), dim=1, stable=True)
    count = taken.sum(dim=1)
    tiles = torch.where(index < count[:, None], order, -1)
    return tiles.to(torch.int32), count.to(torch.int32)


def flash_masked_split_plain(q, k, v, key_valid, splits, tile=_TILE_BK):
    """`flash_sdpa_masked` as the bf16 kernel computes it: per batch element
    the taken tiles of `masked_tile_list_plain` (every tile where none is
    valid) cut into `splits` runs of ceil(taken / splits) tiles (the last
    runs may be short or empty); per run the base-2 logits plus the bias
    (0 / -1e30 log2(e)) of its tiles' real keys, their row maximum, the
    unnormalised weights cast to v's dtype for the value product, their
    float32 sum; then `merge_splits_plain`. q [B, H, Nq, D], k / v
    [B, H, Nk, D], key_valid [B, Nk] bool."""
    nk = k.shape[-2]
    scale_log2 = math.log2(math.e) / math.sqrt(q.shape[-1])
    tiles, count = masked_tile_list_plain(key_valid, tile)
    bias2 = _key_bias(key_valid) * math.log2(math.e)
    out = []
    for b in range(q.shape[0]):
        taken = tiles[b, :int(count[b])] if int(count[b]) \
            else torch.arange(tiles.shape[1], device=q.device)
        per = -(-taken.numel() // splits)
        parts = []
        for s in range(splits):
            run = taken[s * per:(s + 1) * per].long()
            keys = (run[:, None] * tile
                    + torch.arange(tile, device=q.device)).reshape(-1)
            keys = keys[keys < nk]
            t = q[b].float() @ k[b][:, keys].float().transpose(-1, -2)
            t = t * scale_log2 + bias2[b, keys]
            if keys.numel() == 0:
                m = t.new_full(t.shape[:-1] + (1,), -math.inf)
                p = t
            else:
                m = t.amax(dim=-1, keepdim=True)
                p = torch.exp2(t - m)
            parts.append((p.to(v.dtype).float() @ v[b][:, keys].float(), m,
                          p.sum(dim=-1, keepdim=True)))
        out.append(merge_splits_plain(parts))
    return torch.stack(out).to(q.dtype)


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


def _launch_flash(name, q, k, v, key_valid=None, splits=None):
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
    if name == "flash_bh":
        splits, part_o, part_ml = _split_args(q, b * h, nq, nk, d, splits)
        err = _cuda.lib().nttt_flash_bh(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
            *tail[:-1], splits, _ptr(part_o), _ptr(part_ml), tail[-1])
    elif name == "flash_bh_wmma":
        err = _cuda.lib().nttt_flash_bh_wmma(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
            *tail)
    elif name == "flash_masked_wmma":
        bias = _key_bias(key_valid).contiguous()
        err = _cuda.lib().nttt_flash_masked_wmma(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), bias.data_ptr(),
            out.data_ptr(), *tail)
    else:
        splits, part_o, part_ml = _split_args(q, b * h, nq, nk, d, splits)
        # bf16: the mask itself and the pre-pass's scratch; float32: the
        # bias row that the tile of attn_tile.cuh adds per key
        valid = bias = bias2 = tiles = count = None
        if q.dtype == torch.bfloat16:
            valid = key_valid.contiguous().view(torch.uint8)
            bias2, tiles, count = _tile_list_scratch(b, nk, q.device)
        else:
            bias = _key_bias(key_valid).contiguous()
        err = _cuda.lib().nttt_flash_masked(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), _ptr(valid),
            _ptr(bias), out.data_ptr(), *tail[:-1], splits, _ptr(part_o),
            _ptr(part_ml), _ptr(bias2), _ptr(tiles), _ptr(count), tail[-1])
    _cuda.check(err, f"nttt_{name}")
    return out.reshape(lead + (h, nq, d))


def flash_sdpa(q, k, v, *, splits=None):
    """Kernels 11 and 12 as one: unmasked attention over [..., H, N, D]
    operands and result, any key count, D <= 256. Strided views with unit
    stride in D and 16-byte aligned rows are read in place. One call is one
    launch in `LAUNCHES`, whatever the key splits behind it. `splits` forces
    a number of key splits on the bf16 kernel (the checks cross the merge
    with it); the models leave it to `key_splits`."""
    if q.device.type == "cpu" or fusion_disabled():
        return flash_bh_plain(q, k, v)
    _cuda.no_grad_operands("flash_sdpa", q, k, v)
    out = _launch_flash("flash_bh", q, k, v, splits=splits)
    _cuda.count(LAUNCHES, "flash_sdpa")
    return out


def flash_sdpa_wmma(q, k, v):
    """`flash_sdpa` on the tile of `csrc/attn_tile.cuh` for either dtype
    (CUDA tensors only): a second implementation to check and time the bf16
    kernel against. It counts no launch."""
    return _launch_flash("flash_bh_wmma", q, k, v)


def _tile_list_scratch(b, nk, device):
    """What the masked kernel's pre-pass writes per batch element: the
    base-2 bias of every key padded to whole tiles, the taken tiles, their
    count."""
    n_tiles = -(-nk // _TILE_BK)
    n_bias, n_list = b * n_tiles * _TILE_BK, b * n_tiles
    # one allocation, three views
    flat = torch.empty((n_bias + n_list + b,), dtype=torch.int32,
                       device=device)
    return (flat[:n_bias].view(torch.float32).view(b, n_tiles * _TILE_BK),
            flat[n_bias:n_bias + n_list].view(b, n_tiles),
            flat[n_bias + n_list:])


def masked_tile_list(key_valid):
    """The pre-pass of the bf16 `flash_sdpa_masked` kernel alone (CUDA
    tensors only; the checks hold it against `masked_tile_list_plain`):
    key_valid [B, Nk] bool -> (tiles, count) as there, entries past an
    element's count set to -1."""
    _cuda.require(key_valid.is_cuda and key_valid.dim() == 2
                  and key_valid.dtype == torch.bool,
                  "key_valid: a CUDA tensor [B, Nk] bool")
    b, nk = key_valid.shape
    bias2, tiles, count = _tile_list_scratch(b, nk, key_valid.device)
    tiles.fill_(-1)
    err = _cuda.lib().nttt_masked_tile_list(
        key_valid.contiguous().view(torch.uint8).data_ptr(),
        bias2.data_ptr(), tiles.data_ptr(), count.data_ptr(), b, nk,
        _cuda.stream_ptr(key_valid.device))
    _cuda.check(err, "nttt_masked_tile_list")
    return tiles, count


def _check_masked(q, k, key_valid):
    _cuda.require(q.dim() == 4 and key_valid.dtype == torch.bool
                  and key_valid.shape == (q.shape[0], k.shape[-2]),
                  "q [B, H, Nq, D] and key_valid [B, Nk] bool")


def flash_sdpa_masked(q, k, v, key_valid, *, splits=None):
    """Kernel 13: attention over q [B, H, Nq, D], k / v [B, H, Nk, D] with a
    per-batch key-column mask key_valid [B, Nk] (bool, True = attend) shared
    by the heads. A row with no valid key returns the mean of v. Any D <= 256
    in whole 16-byte pieces; the module's docstring says which tile a call
    takes. One call is one launch in `LAUNCHES`, whatever runs behind it
    (pre-pass, key runs, merge). `splits` forces a number of key runs on the
    bf16 kernel (the checks cross the merge with it); the models leave it to
    `key_splits`."""
    _check_masked(q, k, key_valid)
    if q.device.type == "cpu" or fusion_disabled():
        return flash_masked_plain(q, k, v, key_valid)
    _cuda.no_grad_operands("flash_sdpa_masked", q, k, v)
    _cuda.require(key_valid.device == q.device, "key_valid on q's device")
    out = _launch_flash("flash_masked", q, k, v, key_valid, splits)
    _cuda.count(LAUNCHES, "flash_sdpa_masked")
    return out


def flash_sdpa_masked_wmma(q, k, v, key_valid):
    """`flash_sdpa_masked` on the tile of `csrc/attn_tile.cuh` for either
    dtype (CUDA tensors only): a second implementation to check and time
    the bf16 kernel against. It counts no launch."""
    _check_masked(q, k, key_valid)
    _cuda.require(key_valid.device == q.device, "key_valid on q's device")
    return _launch_flash("flash_masked_wmma", q, k, v, key_valid)
