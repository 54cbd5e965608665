"""FPN neck and image-encoder assembly (port of
`no_time_to_train_tpu/models/sam2/neck.py` and `model.Sam2ImageEncoder`;
reference sam2/modeling/backbones/image_encoder.py), NHWC.

The slice reads only the feature maps, so the neck's sine position
encodings (`vision_pos_enc`) are not computed.
"""
import torch.nn as nn

from no_time_to_train_tpu_torch.models.sam2.common import conv1x1
from no_time_to_train_tpu_torch.models.sam2.hiera import Hiera
from no_time_to_train_tpu_torch.ops.resize import resize

__all__ = ["FpnNeck", "Sam2ImageEncoder"]


class _ConvWrap(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, 1)

    def forward(self, x):
        return conv1x1(self.conv, x)


class FpnNeck(nn.Module):
    """1x1 lateral convs and a top-down pathway on the selected levels.
    Input: trunk outputs, highest resolution first; `backbone_channel_list`
    is lowest resolution first, as in the reference config."""

    def __init__(self, d_model, backbone_channel_list, fpn_top_down_levels,
                 fpn_interp_model="nearest"):
        super().__init__()
        self.convs = nn.ModuleList(_ConvWrap(c, d_model)
                                   for c in backbone_channel_list)
        self.top_down = list(fpn_top_down_levels)
        self.interp = fpn_interp_model

    def forward(self, xs):
        n = len(self.convs) - 1
        out = [None] * len(xs)
        prev = None
        for i in range(n, -1, -1):
            lateral = self.convs[n - i](xs[i])
            if i in self.top_down and prev is not None:
                h, w = prev.shape[1:3]
                td = resize(prev.float(), (2 * h, 2 * w), mode=self.interp)
                prev = lateral + td.to(lateral.dtype)
            else:
                prev = lateral
            out[i] = prev
        return out


class Sam2ImageEncoder(nn.Module):
    def __init__(self, cfg, quant="none"):
        super().__init__()
        self.scalp = cfg.scalp
        self.trunk = Hiera(
            embed_dim=cfg.embed_dim, num_heads=cfg.num_heads,
            stages=cfg.stages, global_att_blocks=cfg.global_att_blocks,
            window_pos_embed_bkg_spatial_size=cfg.window_pos_embed_bkg_spatial_size,
            window_spec=cfg.window_spec, quant=quant)
        self.neck = FpnNeck(cfg.d_model, cfg.backbone_channel_list,
                            cfg.fpn_top_down_levels, cfg.fpn_interp_model)

    def forward(self, sample):
        """sample [B, S, S, 3] normalized -> dict(vision_features,
        backbone_fpn: levels highest resolution first, the lowest
        `scalp` dropped)."""
        features = self.neck(self.trunk(sample))
        if self.scalp > 0:
            features = features[:-self.scalp]
        return {"vision_features": features[-1], "backbone_fpn": features}
