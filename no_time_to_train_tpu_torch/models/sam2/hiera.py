"""Hiera image trunk (port of `no_time_to_train_tpu/models/sam2/hiera.py`;
reference sam2/modeling/backbones/hieradet.py), NHWC.

This is the spatial path: every block partitions into windows, attends and
unpartitions on its own. The JAX package's window-major stage flow is a TPU
layout device with the same numbers and is not ported; the window partition
already hands the window kernel the window-major [B * nw, T, 3C] qkv that
the stage flow would.

Under `quant="int8"` (W8A8, ops/quant.py) the JAX package quantizes the MLP
of every block, and the attention's qkv and proj only in the blocks its
stage flow leaves on the spatial path: the stage flow builds its attention
without the quant (JAX hiera.py:199-201). `stage_flow_blocks` names those
blocks as the JAX loop picks them, and their attention runs the float
product on the same weights. The block's dimension-changing `proj` stays
unquantized in both packages (JAX hiera.py:211).
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from no_time_to_train_tpu_torch.models.sam2.common import LayerNorm, MLP
from no_time_to_train_tpu_torch.ops.attention import sdpa_bnhd, window_sdpa_qkv
from no_time_to_train_tpu_torch.ops.quant import Int8Linear, linear_cls
from no_time_to_train_tpu_torch.ops.resize import resize

__all__ = ["Hiera", "window_partition", "window_unpartition"]


def _linear(layer, x, quantized):
    """layer(x); with `quantized` false an Int8Linear runs the float product
    instead (the JAX stage flow's `nn.Dense`: the float32 weight cast to x's
    dtype)."""
    if quantized or not isinstance(layer, Int8Linear):
        return layer(x)
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def window_partition(x, ws):
    """[B, H, W, C] -> ([B*nw, ws, ws, C], (Hp, Wp)) with zero padding."""
    b, h, w, c = x.shape
    pad_h = (ws - h % ws) % ws
    pad_w = (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(windows, ws, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w, :]


def _max_pool_2x2(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class PatchEmbed(nn.Module):
    """The 7x7, stride 4, pad 3 patch embedding (reference PatchEmbed)."""

    def __init__(self, dim):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 7, stride=4, padding=3)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2).to(self.proj.weight.dtype),
                     self.proj.weight, self.proj.bias, stride=4, padding=3)
        return y.permute(0, 2, 3, 1)


class MultiScaleAttention(nn.Module):
    def __init__(self, dim, dim_out, num_heads, q_pool=False, quant="none"):
        super().__init__()
        self.dim_out = dim_out
        self.num_heads = num_heads
        self.q_pool = q_pool
        self.attention_impl = "pallas"
        lin = linear_cls(quant)
        self.qkv = lin(dim, 3 * dim_out)
        self.proj = lin(dim_out, dim_out)

    def forward(self, x, quantized=True):
        """x: [B, H, W, C] -> [B, H', W', dim_out] (H' = H/2 with q-pool).
        Windowed blocks (B = windows > 1) take the window kernel on the
        packed qkv where its gate opens; the rest split the heads as strided
        views of the packed qkv and call `sdpa_bnhd`. `quantized=False`
        runs W8A8 projections as float products."""
        b, h, w, _ = x.shape
        d, nh, impl = self.dim_out, self.num_heads, self.attention_impl
        qkv = _linear(self.qkv, x, quantized).reshape(b, h * w, 3 * d)
        if not self.q_pool and b > 1:
            out = window_sdpa_qkv(qkv, nh, h * w, impl)
            if out is not None:
                return _linear(self.proj, out.reshape(b, h, w, d), quantized)
        q, k, v = qkv.reshape(b, h * w, 3, nh, d // nh).unbind(2)
        if self.q_pool:
            q = _max_pool_2x2(q.reshape(b, h, w, d))
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, nh, d // nh)
        out = sdpa_bnhd(q, k, v, impl).reshape(b, h, w, d)
        return _linear(self.proj, out, quantized)


class MultiScaleBlock(nn.Module):
    def __init__(self, dim, dim_out, num_heads, mlp_ratio=4.0, q_stride=False,
                 window_size=0, quant="none"):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.q_stride = q_stride
        self.window_size = window_size
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads,
                                        q_pool=q_stride, quant=quant)
        self.norm2 = LayerNorm(dim_out, eps=1e-6)
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dim_out, 2,
                       activation="gelu", quant=quant)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)

    def forward(self, x, quantized_attn=True):
        shortcut = x
        xn = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = self.proj(xn)
            if self.q_stride:
                shortcut = _max_pool_2x2(shortcut)
        ws = self.window_size
        h, w = xn.shape[1], xn.shape[2]
        if ws > 0:
            xw, pad_hw = window_partition(xn, ws)
        else:
            xw = xn
        xw = self.attn(xw, quantized_attn)
        if self.q_stride:
            ws = self.window_size // 2
            h, w = shortcut.shape[1:3]
            pad_h = (ws - h % ws) % ws if ws > 0 else 0
            pad_w = (ws - w % ws) % ws if ws > 0 else 0
            pad_hw = (h + pad_h, w + pad_w)
        if self.window_size > 0:
            xw = window_unpartition(xw, ws, pad_hw, (h, w))
        x = shortcut + xw
        return x + self.mlp(self.norm2(x))


class Hiera(nn.Module):
    """Returns the stage outputs [B, H_s, W_s, C_s], highest resolution
    first. `quant="int8"`: W8A8 block GEMMs, as the JAX package's."""

    def __init__(self, embed_dim=96, num_heads=1, stages=(2, 3, 16, 3),
                 q_pool=3, dim_mul=2.0, head_mul=2.0,
                 window_pos_embed_bkg_spatial_size=(14, 14),
                 window_spec=(8, 4, 14, 7), global_att_blocks=(12, 16, 20),
                 quant="none"):
        super().__init__()
        depth = sum(stages)
        self.quant = quant
        self.stage_ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
        self.q_pool_blocks = q_pool_blocks = [
            x + 1 for x in self.stage_ends[:-1]][:q_pool]
        self.patch_embed = PatchEmbed(embed_dim)
        bh, bw = window_pos_embed_bkg_spatial_size
        self.pos_embed = nn.Parameter(torch.zeros(1, embed_dim, bh, bw))
        ws0 = window_spec[0]
        self.pos_embed_window = nn.Parameter(
            torch.zeros(1, embed_dim, ws0, ws0))
        blocks = []
        cur_stage = 1
        for i in range(depth):
            dim_out = embed_dim
            window_size = window_spec[cur_stage - 1]
            if global_att_blocks is not None and i in global_att_blocks:
                window_size = 0
            if i - 1 in self.stage_ends:
                dim_out = int(embed_dim * dim_mul)
                num_heads = int(num_heads * head_mul)
                cur_stage += 1
            blocks.append(MultiScaleBlock(
                embed_dim, dim_out, num_heads, q_stride=i in q_pool_blocks,
                window_size=window_size, quant=quant))
            embed_dim = dim_out
        self.blocks = nn.ModuleList(blocks)

    def _pos_embed_for(self, h, w, dtype):
        pe = resize(self.pos_embed[0].permute(1, 2, 0).float()[None], (h, w),
                    mode="bicubic")[0]
        win = self.pos_embed_window[0].permute(1, 2, 0)
        reps = (h // win.shape[0], w // win.shape[1], 1)
        return (pe + win.float().repeat(*reps)).to(dtype)

    def stage_flow_blocks(self, h, w):
        """The blocks that the JAX package's window-major stage flow runs on
        token-major tensors for a patch grid of h x w (JAX
        `Hiera.__call__`): runs of more than one block of a stage with one
        window size that divides the grid, global blocks included, no
        dimension change or q-pool."""
        blocks, ends, pool = self.blocks, self.stage_ends, self.q_pool_blocks
        flow, i = set(), 0
        while i < len(blocks):
            blk, ws = blocks[i], blocks[i].window_size
            run = []
            if not (i in pool or blk.dim != blk.dim_out or blk.q_stride) \
                    and ws > 0 and h % ws == 0 and w % ws == 0:
                for j in range(i, len(blocks)):
                    bj = blocks[j]
                    if (bj.q_stride or bj.dim != bj.dim_out or j in pool
                            or bj.window_size not in (0, ws)):
                        break
                    run.append(j)
                    if j in ends:
                        break
            if len(run) > 1:
                flow.update(run)
                i = run[-1] + 1
                continue
            if blk.q_stride:
                h, w = h // 2, w // 2
            i += 1
        return flow

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + self._pos_embed_for(x.shape[1], x.shape[2], x.dtype)
        flow = (self.stage_flow_blocks(x.shape[1], x.shape[2])
                if self.quant == "int8" else ())
        outputs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, quantized_attn=i not in flow)
            if i in self.stage_ends:
                outputs.append(x)
        return outputs
