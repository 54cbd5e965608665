"""Fused image-side attention of the SAM2 two-way decoder (port of
`no_time_to_train_tpu/ops/decoder_attention.py`).

`fused_i2t_norm`: image <- token attention + out-projection + residual +
LayerNorm (norm4) in one pass over the per-prompt keys [P, n, C].
`fused_t2i_attn`: token -> image attention with the key and value
projections computed while the keys stream.
`fused_i2t_norm_pair`: layer 0's `fused_i2t_norm` for an image pair in one
launch.

All take the key positional encoding pre-projected through the q (or k)
weight: (keys + pe) @ W == keys @ W + pe @ W, and the projected form is half
the width. On a CUDA tensor each launches its kernel (`csrc/i2t_norm.cu`,
`csrc/t2i_attn.cu`); on a CPU tensor, or inside `no_fusion()`, each runs
its plain version, the unfused formulation of the JAX package's XLA twin.
`fused_i2t_norm_wmma`, `fused_i2t_norm_pair_wmma` and `fused_t2i_attn_wmma`
run the first port's bodies of K3 and K2 (WMMA products, float32 tiles in
shared memory) for either dtype: second implementations to check and time
the bf16 kernels against, called by no model. `fused_shape_error` is the
shape rule of both kernels, which the transformer's gate reads too.

Layer 0 passes keys shared by the prompts of an image: [1, n, C], or
[Bi, n, C] for a batch of Bi images whose P / Bi prompts each lie together
(prompt p reads image p // (P / Bi)). The projections that do not depend on
the prompt are then computed once per image, with a matrix product, before
the kernel.

The prompt-pair bodies are selected as in the JAX package, by the
environment at call time and for an even prompt count: `NTTT_PROMPT_PAIR=1`
sends `fused_i2t_norm` with shared keys to the kernel's two-prompts-a-block
variant, `NTTT_PERPROMPT_PAIR=1` does so for `fused_i2t_norm` and
`fused_t2i_attn` with per-prompt keys. Both are off by default. Each
variant computes the function of the single-prompt kernel and has its own
launch counter.
"""
import os

import torch

from no_time_to_train_tpu_torch.ops import _cuda
from no_time_to_train_tpu_torch.ops.attention import sdpa
from no_time_to_train_tpu_torch.ops.fused_ln import layer_norm_plain
from no_time_to_train_tpu_torch.ops.upscale_product import fusion_disabled

__all__ = ["fused_i2t_norm", "fused_i2t_norm_plain", "fused_i2t_norm_pair",
           "fused_i2t_norm_pair_plain", "fused_i2t_norm_wmma",
           "fused_i2t_norm_pair_wmma", "fused_shape_error", "fused_t2i_attn",
           "fused_t2i_attn_plain", "fused_t2i_attn_wmma", "per_prompt",
           "LAUNCHES"]

LAUNCHES = {"fused_t2i_attn": 0, "fused_i2t_norm": 0,
            "fused_t2i_attn_p2": 0, "fused_i2t_norm_p2": 0,
            "fused_i2t_norm_pre_p2": 0, "fused_i2t_norm_pair": 0}


def _prompt_pair_enabled():
    """Two prompts a block for `fused_i2t_norm` with shared keys."""
    return os.environ.get("NTTT_PROMPT_PAIR", "0") == "1"


def _perprompt_pair_enabled():
    """Two prompts a block for the kernels with per-prompt keys."""
    return os.environ.get("NTTT_PERPROMPT_PAIR", "0") == "1"


def _split(z, h):
    b, m, c = z.shape
    return z.reshape(b, m, h, c // h).transpose(1, 2)


def per_prompt(z, p_):
    """[Pk, ...] -> [P, ...]: image-side rows repeated for their prompts."""
    pk = z.shape[0]
    if pk == p_:
        return z
    if pk == 1:
        return z.expand(p_, *z.shape[1:])
    return z.repeat_interleave(p_ // pk, dim=0)


def _pe3(pe):
    return pe if pe.dim() == 3 else pe[None]


def fused_i2t_norm_plain(keys, pe_q, tok_k, tok_v, wq, bq, wout, bout,
                         norm_w, norm_b, *, num_heads, eps=1e-5):
    """keys [Pk, n, C] (Pk == P, or Pk images of P / Pk prompts each); pe_q
    [n, I] or [Pk, n, I] = pe @ Wq; tok_k/tok_v [P, T, I]; wq [C, I]; bq
    [I]; wout [I, C]; bout [C]; norm_w/b [C]. Returns
    LayerNorm(keys + attn_out) [P, n, C]."""
    p_, _, i = tok_k.shape
    pk, n, c = keys.shape
    dt = keys.dtype
    qi = (keys.reshape(pk * n, c) @ wq.to(dt)).reshape(pk, n, i) \
        + _pe3(pe_q).to(dt) + bq.to(dt)
    o = sdpa(_split(per_prompt(qi, p_), num_heads), _split(tok_k, num_heads),
             _split(tok_v, num_heads))
    o = o.transpose(1, 2).reshape(p_, n, i)
    y = (o.reshape(p_ * n, i) @ wout.to(dt)).reshape(p_, n, c) + bout.to(dt)
    return layer_norm_plain(per_prompt(keys, p_) + y, norm_w, norm_b, eps)


def fused_i2t_norm_pair_plain(keys2, pe_q2, tok_k2, tok_v2, wq, bq, wout,
                              bout, norm_w, norm_b, *, num_heads, eps=1e-5):
    """keys2 [2, n, C]; pe_q2 [2, n, I]; tok_k2/tok_v2 [2, P, T, I]. Returns
    [2, P, n, C]: `fused_i2t_norm_plain` of each image."""
    two, p_, t, i = tok_k2.shape
    out = fused_i2t_norm_plain(
        keys2, pe_q2, tok_k2.reshape(two * p_, t, i),
        tok_v2.reshape(two * p_, t, i), wq, bq, wout, bout, norm_w, norm_b,
        num_heads=num_heads, eps=eps)
    return out.reshape(two, p_, *out.shape[1:])


def fused_t2i_attn_plain(keys, pe_k, tok_q, wk, bk, wv, bv, *, num_heads):
    """keys [Pk, n, C]; pe_k [n, I] or [Pk, n, I] = pe @ Wk; tok_q
    [P, T, I]; wk/wv [C, I]; bk/bv [I]. Returns the attention output
    [P, T, I]."""
    p_, t, i = tok_q.shape
    pk, n, c = keys.shape
    dt = keys.dtype
    kk = (keys.reshape(-1, c) @ wk.to(dt)).reshape(pk, n, i) \
        + _pe3(pe_k).to(dt) + bk.to(dt)
    vv = (keys.reshape(-1, c) @ wv.to(dt)).reshape(pk, n, i) + bv.to(dt)
    o = sdpa(_split(tok_q, num_heads), _split(per_prompt(kk, p_), num_heads),
             _split(per_prompt(vv, p_), num_heads))
    return o.transpose(1, 2).reshape(p_, t, i)


def fused_shape_error(n, c, i, num_heads, t):
    """Why the K2 / K3 kernels refuse n image rows of width C against t
    tokens of width I in `num_heads` heads, or None where they take it. The
    JAX package's decoder gate admits n % 8 == 0; the kernels mask a part
    full last tile of rows, so they take the same n."""
    if not (c == 256 and i == 128 and num_heads == 8):
        return "kernel takes C=256, I=128, 8 heads"
    if not 1 <= t <= 16:
        return f"kernel takes 1..16 tokens, got {t}"
    if n < 1 or n % 8:
        return f"n={n} must be a positive multiple of 8"
    return None


def _check_common(keys, tok, pe, num_heads, shared=None):
    """Shapes the kernels take. Returns (P, T, I, Pk, n, C, shared): with
    `shared` the keys are one set per image (Pk images of P / Pk prompts),
    else one set per prompt (the caller may say which where Pk == P)."""
    req = _cuda.require
    p_, t, i = tok.shape
    pk, n, c = keys.shape
    req(keys.is_cuda and keys.is_contiguous(), "keys: contiguous CUDA tensor")
    err = fused_shape_error(n, c, i, num_heads, t)
    req(err is None, err)
    req(p_ % pk == 0, f"keys batch {pk} must divide the {p_} prompts")
    if shared is None:
        shared = pk == 1 or pk < p_
    req(tuple(pe.shape) == (n, i)
        or (shared and tuple(pe.shape) == (pk, n, i)),
        "positional term must be [n, I], or [Pk, n, I] beside shared keys")
    for z in (tok, pe):
        req(z.device == keys.device and z.dtype == keys.dtype,
            "operands must share the keys' device and dtype")
    return p_, t, i, pk, n, c, shared


def _launch_i2t(entry, keys, peq, tok_k, tok_v, wq, bq, wout, bout, norm_w,
                norm_b, out, *, p_, n, t, ppi, pre, pair, scale, eps):
    """The image <- token kernel through C entry `entry`. pre: `peq` holds
    the scaled, rounded qi [images, n, I] of the shared keys [images, n, C];
    else the projected positional term [n, I] beside per-prompt keys. pair:
    0 one prompt a work item, 1 two prompts, 2 an image pair."""
    dt, dev = keys.dtype, keys.device
    c, i = keys.shape[-1], peq.shape[-1]
    f32 = dict(device=dev, dtype=torch.float32)
    tk = tok_k.contiguous()
    tv = tok_v.to(dt).contiguous()
    wq_t = wq.to(dt).contiguous()
    wo = wout.to(dt).contiguous()
    b_q = bq.to(**f32).contiguous()
    b_o = bout.to(**f32).contiguous()
    nw = norm_w.to(device=dev, dtype=dt).contiguous()
    nb = norm_b.to(device=dev, dtype=dt).contiguous()
    err = getattr(_cuda.lib(), entry)(
        keys.data_ptr(), peq.data_ptr(), tk.data_ptr(), tv.data_ptr(),
        wq_t.data_ptr(), b_q.data_ptr(), wo.data_ptr(), b_o.data_ptr(),
        nw.data_ptr(), nb.data_ptr(), out.data_ptr(), p_, n, 8, t,
        float(scale), float(eps), int(pre), 0 if pre else n * c,
        n * c if pre else 0, n * i if pre else 0, ppi, pair,
        _cuda.dtype_code(dt), _cuda.stream_ptr(dev))
    _cuda.check(err, entry)


def _project_qi(keys, pe_q, wq, bq, scale):
    """Layer 0's qi, once per image: [Pk, n, I], scaled and rounded as the
    kernel rounds it."""
    dt = keys.dtype
    return ((keys.float() @ wq.to(dt).float() + _pe3(pe_q).float()
             + bq.float()) * scale).to(dt).contiguous()


def _i2t(entry, keys, pe_q, tok_k, tok_v, wq, bq, wout, bout, norm_w, norm_b,
         num_heads, eps):
    """K3 through C entry `entry`; returns the output and the name of the
    body it took (a variant under its toggle)."""
    p_, t, i, pk, n, c, pre = _check_common(keys, tok_k, pe_q, num_heads)
    scale = 1.0 / ((i // num_heads) ** 0.5)
    ppi = p_ // pk if pre else 1
    if pre:
        peq = _project_qi(keys, pe_q, wq, bq, scale)
        pair = ppi % 2 == 0 and _prompt_pair_enabled()
        name = "fused_i2t_norm_pre_p2" if pair else "fused_i2t_norm"
    else:
        peq = pe_q.contiguous()
        pair = p_ % 2 == 0 and _perprompt_pair_enabled()
        name = "fused_i2t_norm_p2" if pair else "fused_i2t_norm"
    out = torch.empty((p_, n, c), device=keys.device, dtype=keys.dtype)
    _launch_i2t(entry, keys, peq, tok_k, tok_v, wq, bq, wout, bout, norm_w,
                norm_b, out, p_=p_, n=n, t=t, ppi=ppi, pre=pre,
                pair=int(pair), scale=scale, eps=eps)
    return out, name


def fused_i2t_norm(keys, pe_q, tok_k, tok_v, wq, bq, wout, bout, norm_w,
                   norm_b, *, num_heads, eps=1e-5):
    """Kernel K3, shapes as `fused_i2t_norm_plain`."""
    if keys.device.type == "cpu" or fusion_disabled():
        return fused_i2t_norm_plain(keys, pe_q, tok_k, tok_v, wq, bq, wout,
                                    bout, norm_w, norm_b,
                                    num_heads=num_heads, eps=eps)
    _cuda.no_grad_operands("fused_i2t_norm", keys, pe_q, tok_k, tok_v, wq,
                           bq, wout, bout, norm_w, norm_b)
    out, name = _i2t("nttt_i2t_norm", keys, pe_q, tok_k, tok_v, wq, bq, wout,
                     bout, norm_w, norm_b, num_heads, eps)
    _cuda.count(LAUNCHES, name)
    return out


def fused_i2t_norm_wmma(keys, pe_q, tok_k, tok_v, wq, bq, wout, bout, norm_w,
                        norm_b, *, num_heads, eps=1e-5):
    """`fused_i2t_norm` (and its prompt-pair variants, by the same toggles)
    on the first port's body for either dtype (CUDA tensors only): a second
    implementation to check and time the bf16 kernel against. It counts no
    launch."""
    return _i2t("nttt_i2t_norm_wmma", keys, pe_q, tok_k, tok_v, wq, bq, wout,
                bout, norm_w, norm_b, num_heads, eps)[0]


def _i2t_pair(entry, keys2, pe_q2, tok_k2, tok_v2, wq, bq, wout, bout,
              norm_w, norm_b, num_heads, eps):
    req = _cuda.require
    req(tok_k2.dim() == 4 and tok_k2.shape[0] == 2 and keys2.shape[0] == 2
        and tok_v2.shape == tok_k2.shape, "an image pair: leading axis 2")
    two, ppi, t, i = tok_k2.shape
    req(tuple(pe_q2.shape) == (2, keys2.shape[1], i),
        "positional term must be [2, n, I]")
    tk, tv = (z.reshape(2 * ppi, t, i) for z in (tok_k2, tok_v2))
    p_, t, i, _, n, c, _ = _check_common(keys2, tk, pe_q2, num_heads,
                                         shared=True)
    scale = 1.0 / ((i // num_heads) ** 0.5)
    peq = _project_qi(keys2, pe_q2, wq, bq, scale)
    out = torch.empty((2, ppi, n, c), device=keys2.device, dtype=keys2.dtype)
    _launch_i2t(entry, keys2, peq, tk, tv, wq, bq, wout, bout, norm_w,
                norm_b, out, p_=p_, n=n, t=t, ppi=ppi, pre=True, pair=2,
                scale=scale, eps=eps)
    return out


def fused_i2t_norm_pair(keys2, pe_q2, tok_k2, tok_v2, wq, bq, wout, bout,
                        norm_w, norm_b, *, num_heads, eps=1e-5):
    """Layer 0's K3 for an image pair, one work item serving prompt b of
    both images; shapes as `fused_i2t_norm_pair_plain`."""
    if keys2.device.type == "cpu" or fusion_disabled():
        return fused_i2t_norm_pair_plain(
            keys2, pe_q2, tok_k2, tok_v2, wq, bq, wout, bout, norm_w, norm_b,
            num_heads=num_heads, eps=eps)
    _cuda.no_grad_operands("fused_i2t_norm_pair", keys2, pe_q2, tok_k2,
                           tok_v2, wq, bq, wout, bout, norm_w, norm_b)
    out = _i2t_pair("nttt_i2t_norm", keys2, pe_q2, tok_k2, tok_v2, wq, bq,
                    wout, bout, norm_w, norm_b, num_heads, eps)
    _cuda.count(LAUNCHES, "fused_i2t_norm_pair")
    return out


def fused_i2t_norm_pair_wmma(keys2, pe_q2, tok_k2, tok_v2, wq, bq, wout,
                             bout, norm_w, norm_b, *, num_heads, eps=1e-5):
    """`fused_i2t_norm_pair` on the first port's body for either dtype
    (CUDA tensors only): a second implementation to check and time the bf16
    kernel against. It counts no launch."""
    return _i2t_pair("nttt_i2t_norm_wmma", keys2, pe_q2, tok_k2, tok_v2, wq,
                     bq, wout, bout, norm_w, norm_b, num_heads, eps)


def _t2i(entry, keys, pe_k, tok_q, wk, bk, wv, bv, num_heads):
    """K2 through C entry `entry`; returns the output and the name of the
    body it took (the prompt-pair variant under its toggle)."""
    p_, t, i, pk, n, c, pre = _check_common(keys, tok_q, pe_k, num_heads)
    dt, dev = keys.dtype, keys.device
    scale = 1.0 / ((i // num_heads) ** 0.5)
    f32 = dict(device=dev, dtype=torch.float32)
    b_k = bk.to(**f32).contiguous()
    b_v = bv.to(**f32).contiguous()
    pair = False
    if pre:
        # layer 0: kk and vv are the same for every prompt of an image,
        # project once per image: both [Pk, n, I]
        k0 = keys.float()
        src0 = (k0 @ wk.to(dt).float() + _pe3(pe_k).float() + b_k
                ).to(dt).contiguous()
        src1 = (k0 @ wv.to(dt).float() + b_v).to(dt).contiguous()
        wkv = src0                      # unused by the layer-0 kernel
    else:
        src0, src1 = keys, pe_k.contiguous()
        wkv = torch.cat([wk, wv], dim=1).to(dt).contiguous()
        pair = p_ % 2 == 0 and _perprompt_pair_enabled()
    tq = tok_q.contiguous()
    out = torch.empty((p_, t, i), device=dev, dtype=dt)
    head = (src0.data_ptr(), src1.data_ptr(), tq.data_ptr(), wkv.data_ptr(),
            b_k.data_ptr(), b_v.data_ptr(), out.data_ptr())
    tail = (p_, n, num_heads, t, float(scale), int(pre), 0 if pre else n * c,
            n * i if pre else 0, p_ // pk if pre else 1, int(pair),
            _cuda.dtype_code(dt), _cuda.stream_ptr(dev))
    fn = getattr(_cuda.lib(), entry)
    if entry == "nttt_t2i_attn":
        # scratch of the bf16 kernel's runs of keys: each (prompt, run)
        # leaves a float32 partial that a second kernel merges; the source
        # decides the run count (the float32 body reads no scratch)
        part_o = part_ml = None
        if dt == torch.bfloat16:
            runs = _cuda.lib().nttt_t2i_runs(n)
            part_o = torch.empty((p_ * runs, 16, i), **f32)
            part_ml = torch.empty((p_ * runs, 16, num_heads, 2), **f32)
        err = fn(*head, None if part_o is None else part_o.data_ptr(),
                 None if part_ml is None else part_ml.data_ptr(), *tail)
    else:
        err = fn(*head, *tail)
    _cuda.check(err, entry)
    return out, "fused_t2i_attn_p2" if pair else "fused_t2i_attn"


def fused_t2i_attn(keys, pe_k, tok_q, wk, bk, wv, bv, *, num_heads):
    """Kernel K2, shapes as `fused_t2i_attn_plain`."""
    if keys.device.type == "cpu" or fusion_disabled():
        return fused_t2i_attn_plain(keys, pe_k, tok_q, wk, bk, wv, bv,
                                    num_heads=num_heads)
    _cuda.no_grad_operands("fused_t2i_attn", keys, pe_k, tok_q, wk, bk, wv,
                           bv)
    out, name = _t2i("nttt_t2i_attn", keys, pe_k, tok_q, wk, bk, wv, bv,
                     num_heads)
    _cuda.count(LAUNCHES, name)
    return out


def fused_t2i_attn_wmma(keys, pe_k, tok_q, wk, bk, wv, bv, *, num_heads):
    """`fused_t2i_attn` (and its prompt-pair variant, by the same toggle)
    on the first port's body for either dtype (CUDA tensors only): a second
    implementation to check and time the bf16 kernel against. It counts no
    launch."""
    return _t2i("nttt_t2i_attn_wmma", keys, pe_k, tok_q, wk, bk, wv, bv,
                num_heads)[0]
