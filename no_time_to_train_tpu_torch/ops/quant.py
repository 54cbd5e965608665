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

`Int8Linear` is an `nn.Linear` with its state_dict (names, shapes, init), so
converters and checkpoints load unchanged, as `Int8Dense` does in the JAX
package. Its weight and bias stay float32 through a module cast
(`model.to(torch.bfloat16)`): the JAX package keeps float32 params under a
bf16 compute dtype and quantizes the float32 kernel. It keeps the quantized
weight between calls, keyed by the weight's storage and version counter, so
an in-place write or `load_state_dict` quantizes it again.
"""
import torch
import torch.nn as nn

from no_time_to_train_tpu_torch.ops import _cuda
from no_time_to_train_tpu_torch.ops.upscale_product import fusion_disabled

__all__ = ["Int8Linear", "int8_gemm", "int8_gemm_plain", "int8_linear",
           "int8_linear_plain", "linear_cls", "padded_width", "quant_rows",
           "quant_rows_plain", "LAUNCHES"]

LAUNCHES = {"quant_rows": 0, "int8_gemm": 0}


def padded_width(c):
    """The levels' row length: C rounded up to 16 (the product's 16-byte
    loads)."""
    return (c + 15) // 16 * 16


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


def quant_rows(x):
    """Levels and scales of the rows of x [R, C] (float32 or bf16)."""
    if _plain(x):
        return quant_rows_plain(x)
    _cuda.no_grad_operands("quant_rows", x)
    req = _cuda.require
    req(x.is_cuda and x.dim() == 2 and x.is_contiguous() and x.shape[0] >= 1,
        "quant_rows takes a contiguous CUDA [R >= 1, C] tensor")
    rows, cols = x.shape
    ld = padded_width(cols)
    q = torch.empty((rows, ld), dtype=torch.int8, device=x.device)
    s = torch.empty((rows,), dtype=torch.float32, device=x.device)
    err = _cuda.lib().nttt_quant_rows(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, cols, ld,
        _cuda.dtype_code(x.dtype), _cuda.stream_ptr(x.device))
    _cuda.check(err, "nttt_quant_rows")
    _cuda.count(LAUNCHES, "quant_rows")
    return q, s


def int8_gemm(xq, xs, wq, ws, bias, out_dtype):
    """The int8 product of quantized operands with its scale-and-bias
    epilogue: xq [M, K16], wq [F, K16] from `quant_rows`."""
    if _plain(xq):
        return int8_gemm_plain(xq, xs, wq, ws, bias, out_dtype)
    _cuda.no_grad_operands("int8_gemm", xs, ws, bias)
    req = _cuda.require
    m, k = xq.shape
    f = wq.shape[0]
    req(xq.dtype == wq.dtype == torch.int8 and wq.shape[1] == k
        and k % 16 == 0, "int8_gemm takes int8 [M, K] and [F, K], K % 16 == 0")
    req(xs.shape == (m,) and ws.shape == (f,)
        and xs.dtype == ws.dtype == torch.float32, "float32 scales [M], [F]")
    operands = [xq, wq, xs, ws]
    if bias is not None:
        req(bias.shape == (f,) and bias.dtype == torch.float32,
            "bias float32 [F]")
        operands.append(bias)
    req(all(t.is_cuda and t.device == xq.device and t.is_contiguous()
            for t in operands), "contiguous operands on one CUDA device")
    out = torch.empty((m, f), dtype=out_dtype, device=xq.device)
    err = _cuda.lib().nttt_int8_gemm(
        xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, f, k,
        _cuda.dtype_code(out_dtype), _cuda.stream_ptr(xq.device))
    _cuda.check(err, "nttt_int8_gemm")
    _cuda.count(LAUNCHES, "int8_gemm")
    return out


def _linear(x, quantized_weight, bias, out_dtype):
    lead, c = x.shape[:-1], x.shape[-1]
    xq, xs = quant_rows(x.reshape(-1, c).contiguous())
    wq, ws = quantized_weight
    b = None if bias is None else bias.detach().float().contiguous()
    y = int8_gemm(xq, xs, wq, ws, b, out_dtype or x.dtype)
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
        kept apart."""
        w = self.weight
        plain = _plain(w)
        hit = self._quantized.get(plain)
        if hit is None or hit[0].data_ptr() != w.data_ptr() \
                or hit[1] != w._version:
            ref = w.detach()        # holds the storage: its address stays
            hit = (ref, w._version, quant_rows(ref.contiguous()))
            self._quantized[plain] = hit
        return hit[2]

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
