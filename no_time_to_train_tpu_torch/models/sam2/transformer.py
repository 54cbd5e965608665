"""Two-way transformer of the SAM2 mask decoder (port of
`no_time_to_train_tpu/models/sam2/transformer.py`; reference
sam2/modeling/sam/transformer.py).

The image-side cross-attentions route to the fused kernels
(ops/decoder_attention.py) when `i2t_fusible` holds: the token -> image
attention to K2, the image <- token attention with its residual and norm4
to K3. Otherwise they run the classic unfused formulation.

The image side may be a batch of Bi images with Bi * P prompts, the prompts
of an image lying together: layer 0 then projects the keys once per image
and, for an image pair, takes `fused_i2t_norm_pair`; from layer 0's output
on the keys are per prompt, [Bi * P, n, C].

The token-side work between the image-side passes runs as named steps,
`step(name, fn, *args, key=())` (`call_step`: a plain call): each layer's
self-attention half ("<i>.attend") and its MLP half ("<i>.mlp"). The grid
decode passes its CUDA graph sites as `step` (models/sam2/model.py); the
image-side passes stay outside the graphs, so that nothing a graph holds
between calls is as large as the per-prompt image side.

`RoPEAttention` is the attention of the video memory path (self-attention
and memory cross-attention); under `attention_impl="pallas"` its long
sequences take `flash_sdpa` and `flash_sdpa_masked` through `sdpa`.
"""
import math
from functools import partial

import torch
import torch.nn as nn

from no_time_to_train_tpu_torch.models.sam2.common import MLP, LayerNorm
from no_time_to_train_tpu_torch.models.sam2.pos_enc import (
    apply_rotary, axial_rope_cos_sin)
from no_time_to_train_tpu_torch.ops.attention import sdpa
from no_time_to_train_tpu_torch.ops.decoder_attention import (
    fused_i2t_norm, fused_i2t_norm_pair, fused_shape_error, fused_t2i_attn,
    per_prompt)
from no_time_to_train_tpu_torch.ops.upscale_product import fusion_disabled

__all__ = ["Attention", "RoPEAttention", "TwoWayAttentionBlock",
           "TwoWayTransformer", "call_step"]


def call_step(name, fn, *args, key=()):
    """Run one named token-side step of the decoder: fn(*args). `key` names
    what fn takes besides its tensors (for a graph site in its place)."""
    return fn(*args)


def _prefixed(step, prefix, name, fn, *args, key=()):
    return step(prefix + name, fn, *args, key=key)


def _skip_mask(n_q, n_k, skip_last_n_keys, is_cross_skip, device):
    if skip_last_n_keys <= 0:
        return None
    m = torch.ones((n_q, n_k), dtype=torch.bool, device=device)
    if is_cross_skip:
        m[:, n_k - skip_last_n_keys:] = False
    else:
        m[: n_q - skip_last_n_keys, n_k - skip_last_n_keys:] = False
    return m


class Attention(nn.Module):
    def __init__(self, embedding_dim, num_heads, downsample_rate=1,
                 kv_in_dim=None):
        super().__init__()
        self.internal_dim = embedding_dim // downsample_rate
        self.num_heads = num_heads
        kv_in_dim = embedding_dim if kv_in_dim is None else kv_in_dim
        self.q_proj = nn.Linear(embedding_dim, self.internal_dim)
        self.k_proj = nn.Linear(kv_in_dim, self.internal_dim)
        self.v_proj = nn.Linear(kv_in_dim, self.internal_dim)
        self.out_proj = nn.Linear(self.internal_dim, embedding_dim)

    def _split(self, x):
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads
                         ).transpose(1, 2)

    def forward(self, q, k, v, skip_last_n_keys=0, is_cross_skip=False):
        qh = self._split(self.q_proj(q))
        kh = self._split(self.k_proj(k))
        vh = self._split(self.v_proj(v))
        # an image batch on one side: each image's rows serve its prompts
        nb = max(qh.shape[0], kh.shape[0])
        qh, kh, vh = (per_prompt(z, nb) for z in (qh, kh, vh))
        mask = _skip_mask(qh.shape[-2], kh.shape[-2], skip_last_n_keys,
                          is_cross_skip, q.device)
        out = sdpa(qh, kh, vh, mask=mask)
        b, h, n, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * d))

    def i2t_fusible(self, keys, key_pe, tok_q_in, skip_last_n_keys):
        """True when the fused image-side passes apply: no key masking,
        outside no_fusion(), a positional encoding shared by every prompt,
        and a shape both kernels take (`fused_shape_error`: the decoder's
        widths and heads, <= 16 tokens, image rows n % 8 == 0 as in the JAX
        package's gate), so that no shape admitted here is one the wrappers
        refuse."""
        return (skip_last_n_keys == 0 and not fusion_disabled()
                and key_pe.shape[0] == 1
                and fused_shape_error(keys.shape[-2], keys.shape[-1],
                                      self.internal_dim, self.num_heads,
                                      tok_q_in.shape[1]) is None)

    def i2t_fused_with_norm(self, keys, key_pe, tok_q_in, tok_v_in, norm):
        """norm(keys + self(keys + key_pe, tok_q_in, tok_v_in)) through K3."""
        wq = self.q_proj.weight.t()
        pe_q = key_pe[0] @ wq.to(key_pe.dtype)
        tok_k, tok_v = self.k_proj(tok_q_in), self.v_proj(tok_v_in)
        rest = (wq, self.q_proj.bias, self.out_proj.weight.t(),
                self.out_proj.bias, norm.weight, norm.bias)
        bi, p_ = keys.shape[0], tok_k.shape[0]
        if bi == 2 and p_ > 2:
            # layer 0 of an image pair: one launch serves both images
            out = fused_i2t_norm_pair(
                keys, pe_q[None].expand(2, -1, -1).contiguous(),
                tok_k.reshape(2, p_ // 2, *tok_k.shape[1:]),
                tok_v.reshape(2, p_ // 2, *tok_v.shape[1:]), *rest,
                num_heads=self.num_heads, eps=norm.eps)
            return out.reshape(p_, *out.shape[2:])
        return fused_i2t_norm(keys, pe_q, tok_k, tok_v, *rest,
                              num_heads=self.num_heads, eps=norm.eps)

    def t2i_fused(self, keys, key_pe, tok_q_in):
        """self(tok_q_in, keys + key_pe, keys) through K2."""
        wk = self.k_proj.weight.t()
        pe_k = key_pe[0] @ wk.to(key_pe.dtype)
        o = fused_t2i_attn(keys, pe_k, self.q_proj(tok_q_in), wk,
                           self.k_proj.bias, self.v_proj.weight.t(),
                           self.v_proj.bias, num_heads=self.num_heads)
        return self.out_proj(o)


class RoPEAttention(Attention):
    """Attention with 2D axial RoPE on q and k (reference RoPEAttention).
    The last `num_k_exclude_rope` keys (object-pointer tokens) are not
    rotated; with `rope_k_repeat` the tables repeat along keys that hold
    several frames of the query grid. `key_valid` [B, Nk] bool masks the
    padded slots of a fixed-shape memory bank."""

    def __init__(self, embedding_dim, num_heads, downsample_rate=1,
                 kv_in_dim=None, rope_theta=10000.0, rope_k_repeat=False,
                 feat_sizes=(32, 32)):
        super().__init__(embedding_dim, num_heads, downsample_rate, kv_in_dim)
        self.rope_theta = rope_theta
        self.rope_k_repeat = rope_k_repeat
        self.feat_sizes = tuple(feat_sizes)
        self.attention_impl = "pallas"

    def forward(self, q, k, v, num_k_exclude_rope=0, key_valid=None):
        qh = self._split(self.q_proj(q))
        kh = self._split(self.k_proj(k))
        vh = self._split(self.v_proj(v))
        n_q = qh.shape[-2]
        side = math.isqrt(n_q)
        if side * side != n_q:
            raise ValueError("RoPE attention expects square token grids")
        cos, sin = axial_rope_cos_sin(qh.shape[-1], side, side,
                                      self.rope_theta, device=q.device)
        num_k_rope = kh.shape[-2] - num_k_exclude_rope
        repeat = 1
        if n_q != num_k_rope:
            if not self.rope_k_repeat:
                raise ValueError("key count differs from the query grid "
                                 "without rope_k_repeat")
            repeat = num_k_rope // n_q
        qh = apply_rotary(qh, cos, sin)
        k_rot = apply_rotary(kh[:, :, :num_k_rope], cos, sin,
                             repeat_freqs=repeat)
        kh = (torch.cat([k_rot, kh[:, :, num_k_rope:]], dim=2)
              if num_k_exclude_rope > 0 else k_rot)
        mask = None if key_valid is None else key_valid[:, None, None, :]
        out = sdpa(qh, kh, vh, mask=mask, impl=self.attention_impl)
        b, h, n, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * d))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embedding_dim, num_heads, mlp_dim=2048,
                 attention_downsample_rate=2, skip_first_layer_pe=False):
        super().__init__()
        self.self_attn = Attention(embedding_dim, num_heads)
        self.norm1 = LayerNorm(embedding_dim)
        self.cross_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm2 = LayerNorm(embedding_dim)
        self.mlp = MLP(embedding_dim, mlp_dim, embedding_dim, 2)
        self.norm3 = LayerNorm(embedding_dim)
        self.cross_attn_image_to_token = Attention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm4 = LayerNorm(embedding_dim)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe, skip_last_n_keys=0,
                step=call_step):
        queries, q = step(
            "attend", partial(self._attend, skip_last_n_keys=skip_last_n_keys),
            queries, query_pe, key=(skip_last_n_keys,))

        # token -> image never carries the skip mask (reference)
        t2i = self.cross_attn_token_to_image
        if t2i.i2t_fusible(keys, key_pe, q, 0):
            attn_out = t2i.t2i_fused(keys, key_pe, q)
        else:
            attn_out = t2i(q, keys + key_pe, keys)
        queries, q = step("mlp", self._mlp, queries, attn_out, query_pe)

        i2t = self.cross_attn_image_to_token
        if i2t.i2t_fusible(keys, key_pe, q, skip_last_n_keys):
            keys = i2t.i2t_fused_with_norm(keys, key_pe, q, queries,
                                           self.norm4)
        else:
            attn_out = i2t(keys + key_pe, q, queries,
                           skip_last_n_keys=skip_last_n_keys,
                           is_cross_skip=True)
            keys = self.norm4(per_prompt(keys, attn_out.shape[0]) + attn_out)
        return queries, keys

    def _attend(self, queries, query_pe, skip_last_n_keys=0):
        """The self-attention half: (queries, queries + query_pe)."""
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries,
                                     skip_last_n_keys=skip_last_n_keys)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(
                q, q, queries, skip_last_n_keys=skip_last_n_keys)
        queries = self.norm1(queries)
        return queries, queries + query_pe

    def _mlp(self, queries, attn_out, query_pe):
        """The MLP half after the token -> image attention: (queries,
        queries + query_pe)."""
        queries = self.norm2(queries + attn_out)
        queries = self.norm3(queries + self.mlp(queries))
        return queries, queries + query_pe


class TwoWayTransformer(nn.Module):
    def __init__(self, depth, embedding_dim, num_heads, mlp_dim,
                 attention_downsample_rate=2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm_final_attn = LayerNorm(embedding_dim)

    def forward(self, image_embedding, image_pe, point_embedding,
                skip_last_n_keys=0, step=call_step):
        """image_embedding [Bi, h, w, C] (Bi images, each shared by P / Bi
        prompts that lie together, or one image per prompt), image_pe
        [1 or Bi, h, w, C]; point_embedding [P, N, C]. Returns
        (queries [P, N, C], keys [P, hw, C]). Layer i's token-side steps
        are named "<i>.attend" and "<i>.mlp"."""
        bi, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(bi, h * w, c)
        key_pe = image_pe.reshape(image_pe.shape[0], h * w, c)
        queries = point_embedding
        for i, layer in enumerate(self.layers):
            queries, keys = layer(queries, keys, point_embedding, key_pe,
                                  skip_last_n_keys=skip_last_n_keys,
                                  step=partial(_prefixed, step, f"{i}."))
        q = queries + point_embedding
        fa = self.final_attn_token_to_image
        if fa.i2t_fusible(keys, key_pe, q, skip_last_n_keys):
            attn_out = fa.t2i_fused(keys, key_pe, q)
        else:
            attn_out = fa(q, keys + key_pe, keys,
                          skip_last_n_keys=skip_last_n_keys)
        return self.norm_final_attn(queries + attn_out), keys
