"""Fused image-side attention of the SAM2 two-way decoder (port of
`no_time_to_train_tpu/ops/decoder_attention.py`).

`fused_i2t_norm`: image <- token attention + out-projection + residual +
LayerNorm (norm4) in one pass over the per-prompt keys [P, n, C].
`fused_t2i_attn`: token -> image attention with the key and value
projections computed while the keys stream.

Both take the key positional encoding pre-projected through the q (or k)
weight: (keys + pe) @ W == keys @ W + pe @ W, and the projected form is half
the width. On a CUDA tensor each launches its kernel (`csrc/i2t_norm.cu`,
`csrc/t2i_attn.cu`); on a CPU tensor, or inside `no_fusion()`, each runs
its plain version, the unfused formulation of the JAX package's XLA twin.

Layer 0 passes keys shared by every prompt ([1, n, C]): the projections
that do not depend on the prompt are then computed once, with a matrix
product, before the kernel.

The TPU kernels' prompt-pair and image-pair variants are opt-in experiments
there (off by default) and are not ported.
"""
import torch

from no_time_to_train_tpu_torch.ops import _cuda
from no_time_to_train_tpu_torch.ops.attention import sdpa
from no_time_to_train_tpu_torch.ops.fused_ln import layer_norm_plain
from no_time_to_train_tpu_torch.ops.upscale_product import fusion_disabled

__all__ = ["fused_i2t_norm", "fused_i2t_norm_plain", "fused_t2i_attn",
           "fused_t2i_attn_plain", "LAUNCHES"]

LAUNCHES = {"fused_t2i_attn": 0, "fused_i2t_norm": 0}


def _split(z, h):
    b, m, c = z.shape
    return z.reshape(b, m, h, c // h).transpose(1, 2)


def fused_i2t_norm_plain(keys, pe_q, tok_k, tok_v, wq, bq, wout, bout,
                         norm_w, norm_b, *, num_heads, eps=1e-5):
    """keys [Pk, n, C] (Pk == P or 1); pe_q [n, I] = pe @ Wq; tok_k/tok_v
    [P, T, I]; wq [C, I]; bq [I]; wout [I, C]; bout [C]; norm_w/b [C].
    Returns LayerNorm(keys + attn_out) [P, n, C]."""
    p_, _, i = tok_k.shape
    pk, n, c = keys.shape
    dt = keys.dtype
    qi = (keys.reshape(pk * n, c) @ wq.to(dt)).reshape(pk, n, i) \
        + pe_q.to(dt) + bq.to(dt)
    qi = qi.expand(p_, n, i)
    o = sdpa(_split(qi, num_heads), _split(tok_k, num_heads),
             _split(tok_v, num_heads))
    o = o.transpose(1, 2).reshape(p_, n, i)
    y = (o.reshape(p_ * n, i) @ wout.to(dt)).reshape(p_, n, c) + bout.to(dt)
    return layer_norm_plain(keys + y, norm_w, norm_b, eps)


def fused_t2i_attn_plain(keys, pe_k, tok_q, wk, bk, wv, bv, *, num_heads):
    """keys [Pk, n, C]; pe_k [n, I] = pe @ Wk; tok_q [P, T, I]; wk/wv
    [C, I]; bk/bv [I]. Returns the attention output [P, T, I]."""
    p_, t, i = tok_q.shape
    pk, n, c = keys.shape
    dt = keys.dtype
    kk = (keys.reshape(-1, c) @ wk.to(dt)).reshape(pk, n, i) \
        + pe_k.to(dt) + bk.to(dt)
    vv = (keys.reshape(-1, c) @ wv.to(dt)).reshape(pk, n, i) + bv.to(dt)
    o = sdpa(_split(tok_q, num_heads), _split(kk.expand(p_, n, i), num_heads),
             _split(vv.expand(p_, n, i), num_heads))
    return o.transpose(1, 2).reshape(p_, t, i)


def _check_common(keys, tok, pe, num_heads):
    req = _cuda.require
    p_, t, i = tok.shape
    pk, n, c = keys.shape
    req(keys.is_cuda and keys.is_contiguous(), "keys: contiguous CUDA tensor")
    req(c == 256 and i == 128 and num_heads == 8,
        "kernel takes C=256, I=128, 8 heads")
    req(1 <= t <= 16, f"kernel takes 1..16 tokens, got {t}")
    req(pk in (1, p_), f"keys batch {pk} must be 1 or {p_}")
    req(n % 32 == 0, f"n={n} must be a multiple of 32")
    req(tuple(pe.shape) == (n, i), "positional term must be [n, I]")
    for z in (tok, pe):
        req(z.device == keys.device and z.dtype == keys.dtype,
            "operands must share the keys' device and dtype")
    return p_, t, i, pk, n, c


def fused_i2t_norm(keys, pe_q, tok_k, tok_v, wq, bq, wout, bout, norm_w,
                   norm_b, *, num_heads, eps=1e-5):
    """Kernel K3, shapes as `fused_i2t_norm_plain`."""
    if keys.device.type == "cpu" or fusion_disabled():
        return fused_i2t_norm_plain(keys, pe_q, tok_k, tok_v, wq, bq, wout,
                                    bout, norm_w, norm_b,
                                    num_heads=num_heads, eps=eps)
    p_, t, i, pk, n, c = _check_common(keys, tok_k, pe_q, num_heads)
    dt, dev = keys.dtype, keys.device
    scale = 1.0 / ((i // num_heads) ** 0.5)
    wq_t = wq.to(dt).contiguous()
    f32 = dict(device=dev, dtype=torch.float32)
    pre = pk == 1
    if pre:
        # layer 0: qi is the same for every prompt, project it once
        peq = ((keys[0].float() @ wq_t.float() + pe_q.float()
                + bq.float()) * scale).to(dt).contiguous()
    else:
        peq = pe_q.contiguous()
    tk = tok_k.contiguous()
    tv = tok_v.to(dt).contiguous()
    wo = wout.to(dt).contiguous()
    b_q = bq.to(**f32).contiguous()
    b_o = bout.to(**f32).contiguous()
    nw = norm_w.to(device=dev, dtype=dt).contiguous()
    nb = norm_b.to(device=dev, dtype=dt).contiguous()
    out = torch.empty((p_, n, c), device=dev, dtype=dt)
    err = _cuda.lib().nttt_i2t_norm(
        keys.data_ptr(), peq.data_ptr(), tk.data_ptr(), tv.data_ptr(),
        wq_t.data_ptr(), b_q.data_ptr(), wo.data_ptr(), b_o.data_ptr(),
        nw.data_ptr(), nb.data_ptr(), out.data_ptr(), p_, n, num_heads, t,
        float(scale), float(eps), int(pre), 0 if pre else n * c,
        _cuda.dtype_code(dt), _cuda.stream_ptr(dev))
    _cuda.check(err, "nttt_i2t_norm")
    LAUNCHES["fused_i2t_norm"] += 1
    return out


def fused_t2i_attn(keys, pe_k, tok_q, wk, bk, wv, bv, *, num_heads):
    """Kernel K2, shapes as `fused_t2i_attn_plain`."""
    if keys.device.type == "cpu" or fusion_disabled():
        return fused_t2i_attn_plain(keys, pe_k, tok_q, wk, bk, wv, bv,
                                    num_heads=num_heads)
    p_, t, i, pk, n, c = _check_common(keys, tok_q, pe_k, num_heads)
    dt, dev = keys.dtype, keys.device
    scale = 1.0 / ((i // num_heads) ** 0.5)
    f32 = dict(device=dev, dtype=torch.float32)
    b_k = bk.to(**f32).contiguous()
    b_v = bv.to(**f32).contiguous()
    pre = pk == 1
    if pre:
        # layer 0: kk and vv are the same for every prompt, project once
        k0 = keys[0].float()
        src0 = (k0 @ wk.to(dt).float() + pe_k.float() + b_k).to(dt)
        src1 = (k0 @ wv.to(dt).float() + b_v).to(dt)
        wkv = src0                      # unused by the layer-0 kernel
    else:
        src0, src1 = keys, pe_k.contiguous()
        wkv = torch.cat([wk, wv], dim=1).to(dt).contiguous()
    tq = tok_q.contiguous()
    out = torch.empty((p_, t, i), device=dev, dtype=dt)
    err = _cuda.lib().nttt_t2i_attn(
        src0.data_ptr(), src1.data_ptr(), tq.data_ptr(), wkv.data_ptr(),
        b_k.data_ptr(), b_v.data_ptr(), out.data_ptr(), p_, n, num_heads, t,
        float(scale), int(pre), 0 if pre else n * c, _cuda.dtype_code(dt),
        _cuda.stream_ptr(dev))
    _cuda.check(err, "nttt_t2i_attn")
    LAUNCHES["fused_t2i_attn"] += 1
    return out
