"""Memory encoder of the SAM2 video path (port of
`no_time_to_train_tpu/models/sam2/memory_encoder.py`; reference
sam2/modeling/memory_encoder.py): a stride-2 convolution pyramid over the
mask, a ConvNeXt fuser over the frame's features plus the mask, and the
projection to the memory width.

Public tensors are NHWC, as in the JAX package; the spatial convolutions run
through `F.conv2d` on channel-first views (the JAX package computes them as
plain products outside any Pallas kernel). Parameter names follow the
reference, so a SAM2 state_dict loads unchanged.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from no_time_to_train_tpu_torch.models.sam2.common import (
    LayerNorm2d, _gelu_act, conv1x1)
from no_time_to_train_tpu_torch.models.sam2.pos_enc import sine_pos_table

__all__ = ["MaskDownSampler", "CXBlock", "Fuser", "MemoryEncoder"]


def _layer_norm_cf(x, weight, bias, eps):
    """Channel-first LayerNorm2d on [B, C, H, W]: float32 statistics, the
    normalize and affine in x's dtype (the cast points of `_layer_norm`)."""
    xf = x.float()
    u = xf.mean(dim=1, keepdim=True)
    s = (xf - u).square().mean(dim=1, keepdim=True)
    inv = torch.rsqrt(s + eps)
    wb, bb = weight[None, :, None, None], bias[None, :, None, None]
    if x.dtype == torch.float32:
        return (xf - u) * inv * wb + bb
    y = (x - u.to(x.dtype)) * inv.to(x.dtype)
    return y * wb.to(x.dtype) + bb.to(x.dtype)


class MaskDownSampler(nn.Module):
    """Reference MaskDownSampler: log(total_stride, stride) blocks of
    convolution, LayerNorm2d and GELU that multiply the channels by
    stride^2, then a 1x1 projection to `embed_dim`."""

    def __init__(self, embed_dim=256, kernel_size=4, stride=4, padding=0,
                 total_stride=16):
        super().__init__()
        num_layers = int(math.log2(total_stride) // math.log2(stride))
        layers, chans = [], 1
        for _ in range(num_layers):
            out_chans = chans * stride ** 2
            layers += [nn.Conv2d(chans, out_chans, kernel_size, stride=stride,
                                 padding=padding),
                       LayerNorm2d(out_chans), nn.GELU()]
            chans = out_chans
        layers.append(nn.Conv2d(chans, embed_dim, 1))
        self.encoder = nn.Sequential(*layers)

    def forward(self, x):
        """x [B, H, W, 1] -> [B, H / total_stride, W / total_stride, C]."""
        dt = self.encoder[0].weight.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        for i in range(0, len(self.encoder) - 1, 3):
            conv, norm = self.encoder[i], self.encoder[i + 1]
            x = F.conv2d(x, conv.weight, conv.bias, stride=conv.stride,
                         padding=conv.padding)
            x = _gelu_act(_layer_norm_cf(x, norm.weight, norm.bias, norm.eps))
        return conv1x1(self.encoder[-1], x.permute(0, 2, 3, 1))


class CXBlock(nn.Module):
    """ConvNeXt block: depthwise 7x7, LayerNorm2d, two pointwise layers with
    GELU between them, layer scale, residual."""

    def __init__(self, dim, kernel_size=7, padding=3,
                 layer_scale_init_value=1e-6, use_dwconv=True):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, kernel_size, padding=padding,
                                groups=dim if use_dwconv else 1)
        self.norm = LayerNorm2d(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = (nn.Parameter(layer_scale_init_value * torch.ones(dim))
                      if layer_scale_init_value > 0 else None)

    def forward(self, x):
        """x [B, H, W, C]; the NHWC tensor is the channels-last form of the
        channel-first view that the convolution takes."""
        c = self.dwconv
        y = F.conv2d(x.permute(0, 3, 1, 2), c.weight, c.bias,
                     padding=c.padding, groups=c.groups).permute(0, 2, 3, 1)
        y = self.pwconv2(_gelu_act(self.pwconv1(self.norm(y))))
        if self.gamma is not None:
            y = self.gamma.to(y.dtype) * y
        return x + y


class Fuser(nn.Module):
    def __init__(self, dim, num_layers, kernel_size=7, padding=3,
                 layer_scale_init_value=1e-6, use_dwconv=True,
                 input_projection=False):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim, 1) if input_projection else None
        self.layers = nn.ModuleList(
            CXBlock(dim, kernel_size, padding, layer_scale_init_value,
                    use_dwconv) for _ in range(num_layers))

    def forward(self, x):
        if self.proj is not None:
            x = conv1x1(self.proj, x)
        for layer in self.layers:
            x = layer(x)
        return x


class MemoryEncoder(nn.Module):
    def __init__(self, out_dim, in_dim=256, mask_downsampler_kwargs=None,
                 fuser_num_layers=2, pos_num_feats=64):
        super().__init__()
        self.mask_downsampler = MaskDownSampler(
            embed_dim=in_dim, **(mask_downsampler_kwargs or {}))
        self.pix_feat_proj = nn.Conv2d(in_dim, in_dim, 1)
        self.fuser = Fuser(in_dim, fuser_num_layers)
        self.out_proj = (nn.Conv2d(in_dim, out_dim, 1) if out_dim != in_dim
                         else None)
        self.pos_num_feats = pos_num_feats

    def forward(self, pix_feat, masks, skip_mask_sigmoid=False):
        """pix_feat [B, h, w, C]; masks [B, 16h, 16w, 1]. Returns
        (features [B, h, w, out_dim], position encoding of the same shape)."""
        if not skip_mask_sigmoid:
            masks = torch.sigmoid(masks)
        x = conv1x1(self.pix_feat_proj, pix_feat) + self.mask_downsampler(masks)
        x = self.fuser(x)
        if self.out_proj is not None:
            x = conv1x1(self.out_proj, x)
        pos = sine_pos_table(x.shape[1], x.shape[2], self.pos_num_feats,
                             dtype=x.dtype, device=x.device)
        return x, pos[None].expand(x.shape[0], -1, -1, -1)
