"""Rank-factored grid decoder (port of
`no_time_to_train_tpu/models/sam2/factored_decode.py`), the matcher's
`decoder_impl="factored"`.

The same function as `MaskDecoder.predict_best_of_multimask` for the
prompts of one image, reorganized: the image side changes only through the
image <- token cross-attention, a rank-(heads * T) update, so after the
norm4 LayerNorms the per-prompt keys stay in the form

    keys_i = alpha_i * base + (A_tilde @ G)_i

with `base` [n, C] shared by the prompts, row scales `alpha` [P, n] and
factors `A_tilde` [P, n, r], `G` [P, r, C]. Every later contraction (the
k / v / q projections, the attention logits, the LayerNorm statistics, the
first upscaling deconvolution) is taken against this form, so the per-prompt
[P, n, C] keys are never formed.

Plain PyTorch over the port's `MaskDecoder` module, as the JAX file is plain
XLA over the decoder's parameter tree: the decoder kernels K2, K3 and K4 are
not launched on this path. Torch's Linear layout [out, in] replaces the JAX
kernels' [in, out]. The contractions that the JAX file takes with float32
accumulation take float32 operands here (bf16 products are exact in
float32); the others run in the compute dtype. Token and upscaling norms
call the port's `_layer_norm` (kernel K1 where its gate opens, the JAX
`_ln`'s numerics).
"""
import torch
import torch.nn.functional as F

from no_time_to_train_tpu_torch.models.sam2.common import (
    _gelu_act, _layer_norm)

__all__ = ["factored_best_of_multimask"]


def _dense(lin, x):
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def _kernel(lin, dt):
    """The Linear weight as a [in, out] matrix in dt."""
    return lin.weight.t().to(dt)


def _ln(norm, x):
    return _layer_norm(x, norm.weight, norm.bias, norm.eps)


def _split(x, heads):
    """[..., N, H*D] -> [..., H, N, D] (head-major channels, as Attention)."""
    *lead, n, c = x.shape
    return x.reshape(*lead, n, heads, c // heads).transpose(-2, -3)


def _merge(x):
    """[..., H, N, D] -> [..., N, H*D]."""
    *lead, h, n, d = x.shape
    return x.transpose(-2, -3).reshape(*lead, n, h * d)


def _scale(d, like):
    """1 / sqrt(d) computed in like's dtype, as the JAX file does."""
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=like.dtype,
                                         device=like.device))


def _ein32(eq, *operands):
    """einsum with float32 accumulation and result (the JAX file's
    `preferred_element_type=float32`)."""
    return torch.einsum(eq, *(o.float() for o in operands))


def _token_attn(attn, q_in, k_in, v_in, heads):
    """Dense attention on the token side (T ~ 8), softmax in float32."""
    qh = _split(_dense(attn.q_proj, q_in), heads)
    kh = _split(_dense(attn.k_proj, k_in), heads)
    vh = _split(_dense(attn.v_proj, v_in), heads)
    logits = torch.einsum("...qd,...kd->...qk", qh, kh) * _scale(
        qh.shape[-1], qh)
    probs = torch.softmax(logits.float(), dim=-1).to(qh.dtype)
    out = torch.einsum("...qk,...kd->...qd", probs, vh)
    return _dense(attn.out_proj, _merge(out))


def _ln_update(norm, alpha, base, at, g):
    """keys = LN(alpha * base + At @ G) on the factored form, never forming
    the keys: the row statistics expand algebraically,
    mu = alpha mean(base) + At mean(G) and
    E[x^2] = alpha^2 |base|^2 + 2 alpha <base, At G> + rowquad(At, G G^T).
    Returns (alpha', base', At', G') with base' = base * weight (shared) and
    the rank grown by 2 (the -mu rank-1 term and the LN bias)."""
    p_, n, _ = at.shape
    c = base.shape[-1]
    dt = base.dtype
    a32 = (torch.ones((p_, n), dtype=torch.float32, device=base.device)
           if alpha is None else alpha.float())
    b32 = base.float()
    mu = a32 * b32.mean(-1)[None] + _ein32(
        "pnr,pr->pn", at, g.float().mean(-1).to(dt))
    kg = _ein32("nc,prc->pnr", base, g).to(dt)
    cross = _ein32("pnr,pnr->pn", at, kg)
    gg = _ein32("prc,psc->prs", g, g).to(dt)
    agg = _ein32("pnr,prs->pns", at, gg).to(dt)
    quad = _ein32("pns,pns->pn", agg, at)
    e2 = a32 * a32 * b32.square().sum(-1)[None] + 2.0 * a32 * cross + quad
    var = e2 / c - mu * mu
    inv = torch.rsqrt(var + norm.eps)                          # [P, n]

    w, b = norm.weight.to(dt), norm.bias.to(dt)
    at_new = torch.cat([at * inv[..., None].to(dt),
                        (-inv * mu)[..., None].to(dt),
                        torch.ones((p_, n, 1), dtype=dt, device=at.device)],
                       dim=-1)
    g_new = torch.cat([g * w, w[None, None].expand(p_, 1, c),
                       b[None, None].expand(p_, 1, c)], dim=1)
    return inv * a32, base * w, at_new, g_new


def _t2i_factored(attn, queries, qpe, alpha, base, at, g, pe, heads):
    """Token -> image attention on factored keys and values; returns the
    attention output [P, T, C]."""
    dt = base.dtype
    qh = _split(_dense(attn.q_proj, queries + qpe), heads)    # [P, H, T, d]
    wk, bk = _kernel(attn.k_proj, dt), attn.k_proj.bias.to(dt)
    wv, bv = _kernel(attn.v_proj, dt), attn.v_proj.bias.to(dt)
    # the key input is keys + key_pe = alpha base + At G + pe; the pe and
    # bias terms are not scaled by alpha, so they get their own projections
    base_k = _split((base @ wk)[None], heads)[0]               # [H, n, d]
    pe_k = _split((pe @ wk + bk)[None], heads)[0]
    base_v = _split((base @ wv)[None], heads)[0]
    fk = _split(g @ wk, heads)                                 # [P, H, r, d]
    fv = _split(g @ wv, heads)
    d = qh.shape[-1]
    a = alpha.to(dt)[:, None, None, :]
    logits = (torch.einsum("phtd,hnd->phtn", qh, base_k) * a
              + torch.einsum("phtr,pnr->phtn",
                             torch.einsum("phtd,phrd->phtr", qh, fk), at)
              + torch.einsum("phtd,hnd->phtn", qh, pe_k))
    probs = torch.softmax((logits * _scale(d, logits)).float(),
                          dim=-1).to(dt)                       # [P, H, T, n]
    out = (torch.einsum("phtn,hnd->phtd", probs * a, base_v)
           + torch.einsum("phtr,phrd->phtd",
                          torch.einsum("phtn,pnr->phtr", probs, at), fv)
           + bv.reshape(heads, d)[None, :, None, :])
    return _dense(attn.out_proj, _merge(out))


def _i2t_factored(attn, queries, qpe, alpha, base, at, g, pe, heads):
    """Image -> token attention without per-prompt image queries: the
    logits fold the q projection into the token keys. Returns the rank
    factors (A2 [P, n, H*T], G2 [P, H*T, C]) of its output and the
    out_proj bias, which the caller adds."""
    dt = base.dtype
    wq, bq = _kernel(attn.q_proj, dt), attn.q_proj.bias.to(dt)
    kh = _split(_dense(attn.k_proj, queries + qpe), heads)    # [P, H, T, d]
    vh = _split(_dense(attn.v_proj, queries), heads)
    base_q = _split((base @ wq)[None], heads)[0]               # [H, n, d]
    pe_q = _split((pe @ wq + bq)[None], heads)[0]
    cq = _split(g @ wq, heads)                                 # [P, H, r, d]
    d = kh.shape[-1]
    logits = (torch.einsum("hnd,phtd->phtn", base_q, kh)
              * alpha.to(dt)[:, None, None, :]
              + torch.einsum("phrt,pnr->phtn",
                             torch.einsum("phrd,phtd->phrt", cq, kh), at)
              + torch.einsum("hnd,phtd->phtn", pe_q, kh))
    probs = torch.softmax((logits * _scale(d, logits)).float(),
                          dim=-2).to(dt)                       # over tokens
    wo = _kernel(attn.out_proj, dt)                            # [H*d, C]
    c = wo.shape[-1]
    g2 = torch.einsum("phtd,hdc->phtc", vh, wo.reshape(heads, d, c))
    p_, h_, t, n = probs.shape
    a2 = probs.permute(0, 3, 1, 2).reshape(p_, n, h_ * t)
    return a2, g2.reshape(p_, h_ * t, c), attn.out_proj.bias.to(dt)


def factored_best_of_multimask(decoder, image_embeddings, image_pe, sparse,
                               dense_embeddings, high_res_features=None):
    """`MaskDecoder.predict_best_of_multimask` for the prompts of ONE image
    on the factored form. image_embeddings and dense_embeddings [1, h, w,
    C]; image_pe [h, w, C]; sparse [P, Ts, C]; high_res_features
    ([1, 4h, 4w, C/8], [1, 2h, 2w, C/4]) or None. Returns (mask [P, 4h, 4w],
    iou of the best multimask output [P])."""
    dt = image_embeddings.dtype
    tp = decoder.transformer
    heads = tp.layers[0].self_attn.num_heads
    s = 1 if decoder.pred_obj_scores else 0
    tokens, _ = decoder._tokens(sparse.to(dt))
    tokens = tokens.to(dt)                                     # [P, T, C]
    p_ = tokens.shape[0]
    _, h, w, c = image_embeddings.shape
    n = h * w
    src0 = (image_embeddings + dense_embeddings)[0].reshape(n, c)
    pe = image_pe.reshape(n, c).to(dt)
    ones = torch.ones((p_, n, 1), dtype=dt, device=src0.device)

    # ---- layer 0: the image side is shared by the prompts
    l0 = tp.layers[0]
    queries = _ln(l0.norm1, _token_attn(l0.self_attn, tokens, tokens, tokens,
                                        heads))
    ca = l0.cross_attn_token_to_image
    qh = _split(_dense(ca.q_proj, queries + tokens), heads)
    k0 = _split(_dense(ca.k_proj, (src0 + pe)[None]), heads)[0]
    v0 = _split(_dense(ca.v_proj, src0[None]), heads)[0]
    logits = torch.einsum("phtd,hnd->phtn", qh, k0) * _scale(qh.shape[-1], qh)
    probs = torch.softmax(logits.float(), dim=-1).to(dt)
    attn_out = _dense(ca.out_proj,
                      _merge(torch.einsum("phtn,hnd->phtd", probs, v0)))
    queries = _ln(l0.norm2, queries + attn_out)
    queries = _ln(l0.norm3, queries + l0.mlp(queries))
    # image <- token: the first rank factors
    a0, g0, bo0 = _i2t_factored(
        l0.cross_attn_image_to_token, queries, tokens,
        torch.ones((p_, n), dtype=dt, device=src0.device), src0,
        torch.zeros((p_, n, 1), dtype=dt, device=src0.device),
        torch.zeros((p_, 1, c), dtype=dt, device=src0.device), pe, heads)
    alpha, base, at, g = _ln_update(l0.norm4, None, src0 + bo0[None], a0, g0)

    # ---- layer 1
    l1 = tp.layers[1]
    q_sa = queries + tokens
    queries = _ln(l1.norm1, queries + _token_attn(l1.self_attn, q_sa, q_sa,
                                                  queries, heads))
    attn_out = _t2i_factored(l1.cross_attn_token_to_image, queries, tokens,
                             alpha, base, at, g, pe, heads)
    queries = _ln(l1.norm2, queries + attn_out)
    queries = _ln(l1.norm3, queries + l1.mlp(queries))
    a2, g2, bo2 = _i2t_factored(l1.cross_attn_image_to_token, queries,
                                tokens, alpha, base, at, g, pe, heads)
    alpha, base, at, g = _ln_update(
        l1.norm4, alpha, base, torch.cat([at, a2, ones], dim=-1),
        torch.cat([g, g2, bo2[None, None].expand(p_, 1, c)], dim=1))

    # ---- final token -> image attention and norm
    attn_out = _t2i_factored(tp.final_attn_token_to_image, queries, tokens,
                             alpha, base, at, g, pe, heads)
    queries = _ln(tp.norm_final_attn, queries + attn_out)

    # ---- heads
    iou_pred = decoder.iou_prediction_head(queries[:, s])
    mask_tokens_out = queries[:, s + 1: s + 1 + decoder.num_mask_tokens]
    best = torch.argmax(iou_pred[:, 1:], dim=-1) + 1
    bi = torch.arange(p_, device=best.device)
    hyper_all = torch.stack(
        [decoder.output_hypernetworks_mlps[i](mask_tokens_out[:, i])
         for i in range(decoder.num_mask_tokens)], dim=1)
    hyper_best = hyper_all[bi, best]

    # ---- upscaling: the first deconvolution folded into the factored form
    dc1, ln, dc2 = (decoder.output_upscaling[0], decoder.output_upscaling[1],
                    decoder.output_upscaling[3])
    c1, c2 = c // 4, c // 8
    k1 = dc1.weight.permute(0, 2, 3, 1).reshape(c, 4 * c1).to(dt)
    t1 = (torch.einsum("nm,pn->pnm", base @ k1, alpha.to(dt))
          + torch.einsum("pnr,prm->pnm", at, g @ k1))
    t1 = t1.reshape(p_, h, w, 2, 2, c1) + dc1.bias.to(dt)
    if high_res_features is not None:
        feat_s0, feat_s1 = high_res_features
        s1u = feat_s1.reshape(-1, h, 2, w, 2, c1).permute(0, 1, 3, 2, 4, 5)
        t1 = _ln(ln, t1 + s1u)
    else:
        t1 = _ln(ln, t1)
    u = _gelu_act(t1)
    k2 = dc2.weight.permute(0, 2, 3, 1).reshape(c1, 4 * c2).to(dt)
    t2 = (u.reshape(p_ * n * 4, c1) @ k2).reshape(p_, h, w, 2, 2, 2, 2, c2)
    t2 = t2 + dc2.bias.to(dt)
    if high_res_features is not None:
        s0u = feat_s0.reshape(-1, h, 2, 2, w, 2, 2, c2)
        t2 = t2 + s0u.permute(0, 1, 4, 2, 5, 3, 6, 7)
    gmask = _gelu_act(t2)
    mask_u = torch.einsum("bc,byxpqrsc->byxpqrs", hyper_best, gmask)
    mask = mask_u.permute(0, 1, 3, 5, 2, 4, 6).reshape(p_, 4 * h, 4 * w)
    return mask, iou_pred[bi, best]
