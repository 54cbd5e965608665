"""Fused mask-decoder upscale chain (port of
`no_time_to_train_tpu/ops/upscale_product.py`), and the fusion switch.

`fused_post_t1` runs, for the transformer's src_out [B, hw, d]:
first deconv product + bias + s1 skip -> LayerNorm per 64-wide segment ->
GELU -> second deconv as four K=64 products + bias + s0 skip -> GELU ->
hypernetwork product, and returns the [B, 16, hw] subpixel mask phases
(cols (dy1, dx1, dy2, dx2)). On a CUDA tensor it launches the kernel in
`csrc/upscale_product.cu`; on a CPU tensor it runs `fused_post_t1_plain`,
the same function in plain torch with the kernel's cast points (tanh GELU in
bf16, erf GELU in float32). `fused_post_t1_from_t1` is the same chain from
the raw first-deconv output t1 [B, hw, 4*c1] on (the JAX function called
with `k1mat=None`): the caller computes the first product.
`fused_post_t1_wmma` and `fused_post_t1_from_t1_wmma` run the first port's
body (WMMA products, float32 tiles in shared memory) for either dtype: a
second implementation to check and time the bf16 kernel against, called by
no model.

The skips are [hw, ...] for one image, or [Bi, hw, ...] for a batch of Bi
images whose B / Bi prompts each lie together.

`no_fusion()` routes every fused path of the port to its plain formulation
for the code run inside it; it is the only way a CUDA tensor reaches a plain
version.
"""
import contextlib
import contextvars

import torch
import torch.nn.functional as F

from no_time_to_train_tpu_torch.ops import _cuda

__all__ = ["no_fusion", "fusion_disabled", "fused_post_t1",
           "fused_post_t1_plain", "fused_post_t1_from_t1",
           "fused_post_t1_from_t1_plain", "fused_post_t1_wmma",
           "fused_post_t1_from_t1_wmma", "fold_skips", "LAUNCHES"]

# a contextvar, not a module global, so that a no_fusion() region in one
# thread does not change dispatch in another
_NO_FUSION_DEPTH = contextvars.ContextVar("nttt_torch_no_fusion_depth",
                                          default=0)

LAUNCHES = {"fused_post_t1": 0, "fused_post_t1_from_t1": 0}


@contextlib.contextmanager
def no_fusion():
    """Run the code inside on the plain formulations of every fused kernel."""
    tok = _NO_FUSION_DEPTH.set(_NO_FUSION_DEPTH.get() + 1)
    try:
        yield
    finally:
        _NO_FUSION_DEPTH.reset(tok)


def fusion_disabled():
    return _NO_FUSION_DEPTH.get() > 0


def _gelu(x, bf16):
    return F.gelu(x, approximate="tanh" if bf16 else "none")


def fold_skips(bias1_4, s1f, bias2, s0f16):
    """The deconv biases added into the float32 skip operands, as the Pallas
    kernel's caller does: s1p [..., hw, 4*c1], s0p [..., hw, 16*c2]."""
    s1p = s1f.float() + bias1_4.float()
    s0p = s0f16.float() + bias2.float().repeat(16)
    return s1p.contiguous(), s0p.contiguous()


def _skip_per_prompt(sp, b):
    """[hw, m] or [Bi, hw, m] float skips -> broadcastable to [b, hw, m]."""
    sp = sp.float()
    if sp.dim() == 2:
        return sp[None]
    if sp.shape[0] == 1:
        return sp
    return sp.repeat_interleave(b // sp.shape[0], dim=0)


def _chain_plain(t1, dt, s1p, ln_w, ln_b, k2mat, s0p, hyper, eps):
    """The chain from a float32 t1 [B, hw, 4*c1] on, in compute dtype dt."""
    bf16 = dt == torch.bfloat16
    b, hw, m1 = t1.shape
    c1 = m1 // 4
    c2 = k2mat.shape[1] // 4
    z = (t1 + _skip_per_prompt(s1p, b)).reshape(b, hw, 4, c1)
    mu = z.mean(-1, keepdim=True)
    var = (z - mu).square().mean(-1, keepdim=True)
    zn = (z - mu) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()
    u = _gelu(zn, bf16).to(dt).float()                  # [b, hw, 4, c1]
    t2 = (u @ k2mat.to(dt).float()).reshape(b, hw, 16 * c2)
    g = _gelu(t2 + _skip_per_prompt(s0p, b), bf16).to(dt).float()
    h = hyper.to(dt).float()                             # [b, c2]
    mask = torch.einsum("bpkc,bc->bkp", g.reshape(b, hw, 16, c2), h)
    return mask.to(dt)


def fused_post_t1_from_t1_plain(t1, s1p, ln_w, ln_b, k2mat, s0p, hyper, *,
                                eps=1e-6):
    """Plain torch version of the chain from t1 on, with the kernel's cast
    points. t1 [B, hw, 4*c1] (compute dtype), s1p [hw, 4*c1] or
    [Bi, hw, 4*c1] float, ln_w/ln_b [c1], k2mat [c1, 4*c2], s0p
    [hw, 16*c2] or [Bi, hw, 16*c2] float, hyper [B, c2]. Returns
    [B, 16, hw] in t1's dtype."""
    return _chain_plain(t1.float(), t1.dtype, s1p, ln_w, ln_b, k2mat, s0p,
                        hyper, eps)


def fused_post_t1_plain(src, k1mat, s1p, ln_w, ln_b, k2mat, s0p, hyper, *,
                        eps=1e-6):
    """Plain torch version of the kernel, with its cast points. src
    [B, hw, d] (compute dtype), k1mat [d, 4*c1], the rest as
    `fused_post_t1_from_t1_plain`; t1 stays float32 between the first
    product and the chain. Returns [B, 16, hw] in src's dtype."""
    dt = src.dtype
    t1 = src.float() @ k1mat.to(dt).float()
    return _chain_plain(t1, dt, s1p, ln_w, ln_b, k2mat, s0p, hyper, eps)


def fused_post_t1(src, k1mat, s1p, ln_w, ln_b, k2mat, s0p, hyper, *,
                  eps=1e-6):
    """Kernel K4, shapes as `fused_post_t1_plain`. A CPU tensor, or code
    inside no_fusion(), takes the plain version; a CUDA tensor takes the
    kernel or raises."""
    if src.device.type == "cpu" or fusion_disabled():
        return fused_post_t1_plain(src, k1mat, s1p, ln_w, ln_b, k2mat, s0p,
                                   hyper, eps=eps)
    _cuda.no_grad_operands("fused_post_t1", src, k1mat, s1p, ln_w, ln_b,
                           k2mat, s0p, hyper)
    out = _launch("nttt_upscale_product", src, k1mat, s1p, ln_w, ln_b, k2mat,
                  s0p, hyper, eps)
    _cuda.count(LAUNCHES, "fused_post_t1")
    return out


def fused_post_t1_from_t1(t1, s1p, ln_w, ln_b, k2mat, s0p, hyper, *,
                          eps=1e-6):
    """The kernel's chain from t1 on, shapes as
    `fused_post_t1_from_t1_plain`; dispatch as `fused_post_t1`."""
    if t1.device.type == "cpu" or fusion_disabled():
        return fused_post_t1_from_t1_plain(t1, s1p, ln_w, ln_b, k2mat, s0p,
                                           hyper, eps=eps)
    _cuda.no_grad_operands("fused_post_t1_from_t1", t1, s1p, ln_w, ln_b,
                           k2mat, s0p, hyper)
    out = _launch("nttt_upscale_product", t1, None, s1p, ln_w, ln_b, k2mat,
                  s0p, hyper, eps)
    _cuda.count(LAUNCHES, "fused_post_t1_from_t1")
    return out


def fused_post_t1_wmma(src, k1mat, s1p, ln_w, ln_b, k2mat, s0p, hyper, *,
                       eps=1e-6):
    """`fused_post_t1` on the first port's body for either dtype (CUDA
    tensors only): a second implementation to check and time the bf16
    kernel against. It counts no launch."""
    return _launch("nttt_upscale_product_wmma", src, k1mat, s1p, ln_w, ln_b,
                   k2mat, s0p, hyper, eps)


def fused_post_t1_from_t1_wmma(t1, s1p, ln_w, ln_b, k2mat, s0p, hyper, *,
                               eps=1e-6):
    """`fused_post_t1_from_t1` on the first port's body, as
    `fused_post_t1_wmma`."""
    return _launch("nttt_upscale_product_wmma", t1, None, s1p, ln_w, ln_b,
                   k2mat, s0p, hyper, eps)


def _launch(entry, src, k1mat, s1p, ln_w, ln_b, k2mat, s0p, hyper, eps):
    """K4 through C entry `entry`; k1mat None: `src` is t1 and the first
    product is left out."""
    req = _cuda.require
    dt = src.dtype
    dev = src.device
    b, hw, d = src.shape
    from_t1 = k1mat is None
    req(src.is_cuda and src.is_contiguous(), "src must be contiguous CUDA")
    req((d, k2mat.shape[0], k2mat.shape[1]) == (256, 64, 128)
        and (from_t1 or tuple(k1mat.shape) == (256, 256)),
        "kernel takes d=256, c1=64, c2=32")
    req(hw >= 8 and hw % 8 == 0, f"hw={hw} must be a positive multiple of 8")
    if s1p.dim() == 2:
        s1p, s0p = s1p[None], s0p[None]
    n_img = s1p.shape[0]
    req(tuple(s1p.shape) == (n_img, hw, 256)
        and tuple(s0p.shape) == (n_img, hw, 512) and b % n_img == 0,
        "skip shapes")
    req(tuple(hyper.shape) == (b, 32), "hyper shape")
    k2 = k2mat.to(device=dev, dtype=dt).contiguous()
    k1 = k2 if from_t1 else k1mat.to(device=dev, dtype=dt).contiguous()
    f32 = dict(device=dev, dtype=torch.float32)
    s1 = s1p.to(**f32).contiguous()
    s0 = s0p.to(**f32).contiguous()
    lw = ln_w.to(**f32).contiguous()
    lb = ln_b.to(**f32).contiguous()
    hy = hyper.to(**f32).contiguous()
    out = torch.empty((b, 16, hw), device=dev, dtype=dt)
    err = getattr(_cuda.lib(), entry)(
        src.data_ptr(), k1.data_ptr(), s1.data_ptr(), lw.data_ptr(),
        lb.data_ptr(), k2.data_ptr(), s0.data_ptr(), hy.data_ptr(),
        out.data_ptr(), b, hw, 32, b // n_img, int(from_t1), float(eps),
        _cuda.dtype_code(dt), _cuda.stream_ptr(dev))
    _cuda.check(err, entry)
    return out
