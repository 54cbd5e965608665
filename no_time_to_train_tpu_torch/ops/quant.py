"""W8A8 int8 linear layers for the encoder towers (port of
`no_time_to_train_tpu/ops/quant.py`), the opt-in `encoder_quant="int8"`.

Dynamic W8A8 as the JAX package's `int8_dot` computes it: activation scales
per row, absmax / 127 with 0 replaced by 1; weight scales per output
channel, which in torch's [F, C] layout are the weight's rows too, so one
quantize serves both operands; levels round(x / s) with ties to even,
clipped to [-127, 127]; int32 sums; then (float(acc) * xs) * ks + bias in
float32, cast to the output dtype.

`quant_rows` and `int8_gemm` launch the two kernels of
`csrc/int8_linear.cu` on a CUDA tensor; on a CPU tensor, or inside
`no_fusion()`, they run `quant_rows_plain` and `int8_gemm_plain`, the same
functions in plain torch (the integer product exact through a float64
product: |acc| <= 127^2 C < 2^53). The levels are [rows, C16] with C16 the
width rounded up to 16 and the padding zero, the product's operand layout.
`int8_linear` quantizes the weight at every call, as `int8_dot` does;
`int8_linear_plain` is the whole layer in plain torch.

The kernels' launch shapes are chosen here, in plain Python that the CPU
tests reach: `quant_plan` (threads a row and 8-column units a thread, by
width: the row is read once into registers with 16-byte loads and its
levels stored 8 bytes a unit) and `gemm_plan` (the product's tile width,
the split of K and the persistent grid: `wgmma` on s8 operands fed by a TMA
ring, one block an SM, K split where a cost model fitted on the card says
that shortens the busiest block).
Both kernels have one launch route, `_launch` (one call of
`nttt_int8_linear`, which runs the quantize, the product or both, after one
set of checks): `quant_rows` and `int8_gemm` launch one kernel each, and a
W8A8 layer on the card (`Int8Linear`, `int8_linear`) both from one call,
its activation's levels and scales in one buffer of that call (host time
of a layer: PERF.md "PR 16").
`quant_rows_warp` and `int8_gemm_mma` run the kernels' first bodies (a
warp a row; `mma.sync` tiles on two `cp.async` stages) on CUDA tensors
only, to check and time the new ones against; they count no launch.

`Int8Linear` is an `nn.Linear` with its state_dict (names, shapes, init), so
converters and checkpoints load unchanged, as `Int8Dense` does in the JAX
package. Its weight and bias stay float32 through a module cast
(`model.to(torch.bfloat16)`): the JAX package keeps float32 params under a
bf16 compute dtype and quantizes the float32 kernel. It keeps the quantized
weight between calls, keyed by the weight's storage and version counter, so
an in-place write or `load_state_dict` quantizes it again.
"""
import functools
from typing import NamedTuple

import torch
import torch.nn as nn

from no_time_to_train_tpu_torch.ops import _cuda
from no_time_to_train_tpu_torch.ops.graph_inputs import held
from no_time_to_train_tpu_torch.ops.upscale_product import fusion_disabled

__all__ = ["GemmPlan", "Int8Linear", "gemm_plan", "int8_gemm",
           "int8_gemm_mma", "int8_gemm_plain", "int8_linear",
           "int8_linear_plain", "linear_cls", "padded_width", "quant_plan",
           "quant_rows", "quant_rows_plain", "quant_rows_warp", "LAUNCHES"]

LAUNCHES = {"quant_rows": 0, "int8_gemm": 0}


def padded_width(c):
    """The levels' row length: C rounded up to 16 (the product's 16-byte
    loads)."""
    return (c + 15) // 16 * 16


# quant_rows: threads a row (powers of two; a block holds 256 threads) and
# 8-column units a thread (the compiled register widths: the plan picks from
# the first QUANT_FIT, wider rows take the rest)
QUANT_TPR = (1, 2, 4, 8, 16, 32, 64, 128, 256)
QUANT_VEC = (1, 2, 3, 4, 5, 6, 8, 16)
QUANT_FIT = 6


@functools.lru_cache(maxsize=1024)
def quant_plan(cols):
    """(threads a row, units a thread) of `quant_rows` at width `cols`:
    over one to six units of 8 columns a thread, each with the fewest
    threads that cover the row, the fewest thread slots, then the most
    units a thread (144: 4 x 5, eight rows a warp; 1024: 32 x 4, a warp a
    row; 4608: 128 x 5, two rows a block); rows wider than 256 x 6 units
    take 8 or 16 a thread. Fitted to a sweep on an H100 (`chip_smoke.py
    --int8-plans`)."""
    units = padded_width(cols) // 8
    fits = [(t * v, -v, t) for v in QUANT_VEC[:QUANT_FIT] for t in QUANT_TPR
            if t * v >= units]
    if not fits:
        t = QUANT_TPR[-1]
        fits = [(t * v, -v, t) for v in QUANT_VEC[QUANT_FIT:]
                if t * v >= units]
        if not fits:
            raise ValueError(f"quant_rows takes rows of at most "
                             f"{8 * t * QUANT_VEC[-1]} values, got {cols}")
    _, vec, tpr = min(fits)
    return tpr, -vec


# int8_gemm: tile rows (two consumer warpgroups of 64), bytes of K a stage
# of the TMA ring, the compiled tile widths, the most slices of K and the
# most tiles a split may cover (past that the tiles fill the SMs, and a
# split's int32 scratch would outgrow the output), and the deepest K whose
# product stores its bf16 rows by the bulk copy engine
GEMM_BM, GEMM_BK = 128, 128
GEMM_BN = (256, 144, 128, 64)
GEMM_MAX_SPLIT = 4
GEMM_SPLIT_TILES = 1024
GEMM_BULK_K = 576
# the cost model of `gemm_plan`, in SM clocks: the int8 tensor-core rate
# (4096 multiply-adds a clock an SM: 1979 TOPS over 132 SMs), the rate at
# which a block's ring fills and at which a split's scratch sums move, in
# bytes a clock; fitted to a sweep of every tile width and split at 17
# layer shapes of the three towers on an H100 (`chip_smoke.py
# --int8-plans`), where it picks the fastest plan at 16 and one within 7 %
# of the fastest at the 17th
_MAC_CLK, _FILL_B_CLK, _SPLIT_B_CLK = 4096, 64, 32


class GemmPlan(NamedTuple):
    """A launch of the int8 product: tile width `bn`, K in `split` slices of
    `per` 128-byte steps, `tiles` output tiles, `units` = tiles x split work
    units walked by `grid` persistent blocks; `bulk` stores the bf16 rows
    by the bulk copy engine."""
    bn: int
    split: int
    per: int
    tiles: int
    units: int
    grid: int
    bulk: bool


def _plan(m, k, f, bn, split, sms):
    ksteps = -(-k // GEMM_BK)
    per = -(-ksteps // split)
    split = -(-ksteps // per)
    tiles = -(-m // GEMM_BM) * -(-f // bn)
    units = tiles * split
    return GemmPlan(bn, split, per, tiles, units, min(units, sms),
                    k <= GEMM_BULK_K)


def _cost(k, plan, sms):
    """Clocks of the busiest block: its units one after another, each the
    longer of its products and its ring's fill, plus under a split its
    scratch sums written and read."""
    kb = min(plan.per * GEMM_BK, k)
    mma = GEMM_BM * plan.bn * kb / _MAC_CLK
    fill = (GEMM_BM + plan.bn) * kb / _FILL_B_CLK
    unit = max(mma, fill)
    if plan.split > 1:
        unit += 2 * GEMM_BM * plan.bn * 4 / _SPLIT_B_CLK
    return -(-plan.units // sms) * unit


@functools.lru_cache(maxsize=1024)
def gemm_plan(m, k, f, sms=132):
    """The launch of `int8_gemm` for xq [m, k] . wq [f, k]^T on `sms` SMs:
    the tile width and split of K with the least modelled time of the
    busiest block (ties: the fewer units); a split only where the tiles
    are fewer than `GEMM_SPLIT_TILES`. Deterministic."""
    ksteps = -(-k // GEMM_BK)
    best = None
    for bn in GEMM_BN:
        for split in range(1, min(GEMM_MAX_SPLIT, ksteps) + 1):
            plan = _plan(m, k, f, bn, split, sms)
            if plan.split != split or (
                    split > 1 and plan.tiles > GEMM_SPLIT_TILES):
                continue
            key = (_cost(k, plan, sms), plan.units)
            if best is None or key < best[0]:
                best = (key, plan)
    return best[1]


def _plain(t):
    return t.device.type == "cpu" or fusion_disabled()


def quant_rows_plain(x):
    """x [R, C] float -> (levels [R, C16] int8, zero past C; scales [R]
    float32)."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    # a tensor divisor: torch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which rounds differently from IEEE division
    s = amax / torch.full_like(amax, 127.0)
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(xf / s[:, None]), -127, 127).to(torch.int8)
    pad = padded_width(x.shape[-1]) - x.shape[-1]
    return torch.nn.functional.pad(q, (0, pad)), s


def int8_gemm_plain(xq, xs, wq, ws, bias, out_dtype):
    """(float(xq . wq^T) * xs) * ws + bias in float32, cast to out_dtype:
    xq [M, K], wq [F, K] int8, xs [M], ws [F], bias [F] or None."""
    acc = (xq.double() @ wq.double().T).float()
    y = acc * xs[:, None] * ws[None, :]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def _quant_args(x):
    """The checked operand of a quantize: (pointer, rows, cols, ld,
    dtype code)."""
    _cuda.no_grad_operands("quant_rows", x)
    _cuda.require(
        x.is_cuda and x.dim() == 2 and x.is_contiguous() and x.shape[0] >= 1,
        "quant_rows takes a contiguous CUDA [R >= 1, C] tensor")
    rows, cols = x.shape
    return (x.data_ptr(), rows, cols, padded_width(cols),
            _cuda.dtype_code(x.dtype))


def _levels(rows, ld, device):
    return (torch.empty((rows, ld), dtype=torch.int8, device=device),
            torch.empty((rows,), dtype=torch.float32, device=device))


def _weight_args(wq, ws, bias, k, d):
    """The checked weight side of a product over K = k on CUDA device `d`:
    ((wq, ws, bias) pointers, F)."""
    _cuda.no_grad_operands("int8_gemm", ws, bias)
    req = _cuda.require
    f = wq.shape[0]
    req(wq.dtype == torch.int8 and wq.dim() == 2 and wq.shape[1] == k
        and k % 16 == 0, "int8_gemm takes int8 [M, K] and [F, K], K % 16 == 0")
    req(ws.shape == (f,) and ws.dtype == torch.float32, "float32 scales [F]")
    operands = [wq, ws]
    if bias is not None:
        req(bias.shape == (f,) and bias.dtype == torch.float32,
            "bias float32 [F]")
        operands.append(bias)
    req(d >= 0 and all(t.get_device() == d and t.is_contiguous()
                       for t in operands),
        "contiguous operands on one CUDA device")
    ptrs = (wq.data_ptr(), ws.data_ptr(),
            None if bias is None else bias.data_ptr())
    req(ptrs[0] % 16 == 0,
        "int8_gemm's TMA loads take 16-byte aligned operands")
    req(ptrs[1] % 8 == 0 and (ptrs[2] is None or ptrs[2] % 8 == 0),
        "int8_gemm's epilogue reads 8-byte aligned scales and bias")
    return ptrs, f


def _gemm_args(xq, xs, wq, ws, bias):
    """The checked operands of a product of quantized rows xq [M, K], xs
    [M]: (xq, xs) pointers, M, K, and `_weight_args`'s."""
    _cuda.no_grad_operands("int8_gemm", xs)
    m, k = xq.shape
    d = xq.get_device()
    _cuda.require(
        xq.dtype == torch.int8 and xs.shape == (m,)
        and xs.dtype == torch.float32 and d >= 0 and xs.get_device() == d
        and xq.is_contiguous() and xs.is_contiguous(),
        "int8_gemm takes contiguous CUDA int8 [M, K] and float32 [M]")
    _cuda.require(xq.data_ptr() % 16 == 0,
                  "int8_gemm's TMA loads take 16-byte aligned operands")
    return (xq.data_ptr(), xs.data_ptr(), m, k,
            *_weight_args(wq, ws, bias, k, d))


_SMS = {}


def _sm_count(device):
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _plan_args(m, k, f, dev, plan=None):
    """The product's launch arguments after its operands, (bn, split,
    grid, bulk, scratch) of `plan` or of `gemm_plan`'s choice, and the
    split's int32 scratch (its sums, then a counter a tile, which the entry
    zeroes), allocated on the current stream here, which the caller holds
    until the launch (then the caching allocator hands it on only to later
    work of the stream; under a graph's capture it is the graph's)."""
    if plan is None:
        p = gemm_plan(m, k, f, _sm_count(dev))
    else:
        p, ref = plan, _plan(m, k, f, plan.bn, plan.split, plan.grid)
        _cuda.require(p.bn in GEMM_BN and p._replace(bulk=ref.bulk) == ref
                      and (p.split == 1 or p.tiles <= GEMM_SPLIT_TILES),
                      f"not a plan of ({m}, {k}, {f}): {p}")
    if p.split == 1:
        return (p.bn, 1, p.grid, int(p.bulk), None), None
    scratch = torch.empty(p.units * GEMM_BM * p.bn + p.tiles,
                          dtype=torch.int32, device=dev)
    return (p.bn, p.split, p.grid, int(p.bulk), scratch.data_ptr()), scratch


def _launch(dev, q, s, rows, ld, x=None, weight=None, out=None, qplan=None,
            plan=None):
    """The one launch route of both kernels, `nttt_int8_linear`: where
    `x` = (pointer, cols, dtype code) is given, its quantize into the
    levels `q` [rows, ld] and scales `s` (pointers); then, where `weight` =
    `_weight_args(...)` is given, the product of q, s and the weight into
    `out`, on `plan` or `gemm_plan`'s. Counts the kernels it launched."""
    xp, cols, dtype = x or (None, 0, 0)
    tpr, vec = (qplan or quant_plan(cols)) if x else (0, 0)
    if weight is None:
        gemm, _scratch_held = (None, None, None, None, 0, 0, 0, 1, 1, 0,
                               None), None
    else:
        (wq, ws, bias), f = weight
        launch, _scratch_held = _plan_args(rows, ld, f, dev, plan)
        gemm = (wq, ws, bias, out.data_ptr(), f, _cuda.dtype_code(out.dtype),
                *launch)
    err = _cuda.lib().nttt_int8_linear(xp, q, s, rows, cols, ld, dtype, tpr,
                                       vec, *gemm, _cuda.stream_ptr(dev))
    _cuda.check(err, "nttt_int8_linear")
    if x:
        _cuda.count(LAUNCHES, "quant_rows")
    if weight:
        _cuda.count(LAUNCHES, "int8_gemm")


def quant_rows(x, plan=None):
    """Levels and scales of the rows of x [R, C] (float32 or bf16); `plan`
    (threads a row, units a thread) overrides `quant_plan`'s."""
    if _plain(x):
        return quant_rows_plain(x)
    xp, rows, cols, ld, dtype = _quant_args(x)
    q, s = _levels(rows, ld, x.device)
    _launch(x.device, q.data_ptr(), s.data_ptr(), rows, ld,
            x=(xp, cols, dtype), qplan=plan)
    return q, s


def quant_rows_warp(x):
    """`quant_rows` on the kernel's first body (CUDA tensors only)."""
    xp, rows, cols, ld, dtype = _quant_args(x)
    q, s = _levels(rows, ld, x.device)
    err = _cuda.lib().nttt_quant_rows_warp(
        xp, q.data_ptr(), s.data_ptr(), rows, cols, ld, dtype,
        _cuda.stream_ptr(x.device))
    _cuda.check(err, "nttt_quant_rows_warp")
    return q, s


def int8_gemm(xq, xs, wq, ws, bias, out_dtype, plan=None):
    """The int8 product of quantized operands with its scale-and-bias
    epilogue: xq [M, K16], wq [F, K16] from `quant_rows`; `plan` (a
    `GemmPlan`) overrides `gemm_plan`'s choice, as checks of other tile
    widths and splits do."""
    if _plain(xq):
        return int8_gemm_plain(xq, xs, wq, ws, bias, out_dtype)
    qp, sp, m, k, w, f = _gemm_args(xq, xs, wq, ws, bias)
    out = torch.empty((m, f), dtype=out_dtype, device=xq.device)
    _launch(xq.device, qp, sp, m, k, weight=(w, f), out=out, plan=plan)
    return out


def int8_gemm_mma(xq, xs, wq, ws, bias, out_dtype):
    """`int8_gemm` on the kernel's first body (CUDA tensors only)."""
    qp, sp, m, k, (wp, wsp, bp), f = _gemm_args(xq, xs, wq, ws, bias)
    out = torch.empty((m, f), dtype=out_dtype, device=xq.device)
    err = _cuda.lib().nttt_int8_gemm_mma(
        qp, wp, sp, wsp, bp, out.data_ptr(), m, f, k,
        _cuda.dtype_code(out_dtype), _cuda.stream_ptr(xq.device))
    _cuda.check(err, "nttt_int8_gemm_mma")
    return out


def _linear(x, quantized_weight, bias, out_dtype):
    lead, c = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, c).contiguous()
    wq, ws = quantized_weight
    b = None if bias is None else bias.detach().float().contiguous()
    dtype = out_dtype or x.dtype
    if _plain(x2):
        y = int8_gemm_plain(*quant_rows_plain(x2), wq, ws, b, dtype)
    else:
        # one call of both kernels; the levels and scales, which only the
        # product reads, in one buffer of this call
        xp, rows, cols, ld, xd = _quant_args(x2)
        weight = _weight_args(wq, ws, b, ld, x2.get_device())
        s_off = (rows * ld + 15) // 16 * 16
        buf = torch.empty(s_off + 4 * rows, dtype=torch.int8, device=x.device)
        y = torch.empty((rows, weight[1]), dtype=dtype, device=x.device)
        q = buf.data_ptr()
        _launch(x.device, q, q + s_off, rows, ld, x=(xp, cols, xd),
                weight=weight, out=y)
    return y.reshape(*lead, wq.shape[0])


def int8_linear(x, weight, bias=None, out_dtype=None):
    """W8A8 x [..., C] . weight [F, C]^T + bias -> [..., F] in out_dtype
    (x's by default); the weight quantized at this call."""
    return _linear(x, quant_rows(weight.detach().contiguous()), bias,
                   out_dtype)


def int8_linear_plain(x, weight, bias=None, out_dtype=None):
    """`int8_linear` in plain torch, whatever the device."""
    xq, xs = quant_rows_plain(x.reshape(-1, x.shape[-1]))
    wq, ws = quant_rows_plain(weight)
    y = int8_gemm_plain(xq, xs, wq, ws, bias, out_dtype or x.dtype)
    return y.reshape(*x.shape[:-1], weight.shape[0])


class Int8Linear(nn.Linear):
    """`nn.Linear` on the W8A8 int8 product; float32 master weights."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._quantized = {}

    def _apply(self, fn, recurse=True):
        def keep_float32(t):
            out = fn(t)
            if t.is_floating_point() and out.dtype != t.dtype:
                return t.to(out.device)    # moved, never rounded
            return out
        self._quantized = {}
        return super()._apply(keep_float32, recurse)

    def quantized_weight(self):
        """(levels [F, C16], scales [F]) of the weight, quantized again
        after any write to it; the kernel's and the plain version's are
        kept apart. A CUDA graph that reads them keeps them, and is
        dropped after a write to the weight (`held`)."""
        w = self.weight
        plain = _plain(w)
        hit = self._quantized.get(plain)
        if hit is None or hit[0].data_ptr() != w.data_ptr() \
                or hit[1] != w._version:
            ref = w.detach()        # holds the storage: its address stays
            hit = (ref, w._version, quant_rows(ref.contiguous()))
            self._quantized[plain] = hit
        return held(hit[2], source=w)

    def forward(self, x):
        return _linear(x, self.quantized_weight(), self.bias, x.dtype)


def linear_cls(quant):
    """The linear layer of a tower: "none" -> nn.Linear, "int8" ->
    Int8Linear (the JAX package's `dense_cls`)."""
    if quant == "int8":
        return Int8Linear
    if quant in (None, "none"):
        return nn.Linear
    raise ValueError(f"encoder_quant={quant!r}: 'none' or 'int8'")
