"""FPN neck and image-encoder assembly (port of
`no_time_to_train_tpu/models/sam2/neck.py` and `model.Sam2ImageEncoder`;
reference sam2/modeling/backbones/image_encoder.py), NHWC.

The slice reads only the feature maps, so the neck's sine position
encodings (`vision_pos_enc`) are not computed.

On the card `Sam2ImageEncoder` replays Hiera, the neck and the decoder's two
high-resolution 1x1 convolutions as one CUDA graph a call
(`ops/graph_call.py`; counters in `graph_stats` under the site "image").
"""
import torch.nn as nn

from no_time_to_train_tpu_torch.models.sam2.common import conv1x1
from no_time_to_train_tpu_torch.models.sam2.hiera import Hiera
from no_time_to_train_tpu_torch.ops.graph_call import (
    GraphOwner, GraphSite, graph_stats)
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


class Sam2ImageEncoder(GraphOwner):
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
        self.graph_stats = graph_stats()
        self._graph = GraphSite("image", self.graph_stats)

    def forward(self, sample, high_res=None):
        """sample [B, S, S, 3] normalized -> dict(vision_features,
        backbone_fpn: levels highest resolution first, the lowest
        `scalp` dropped). `high_res`: the two 1x1 convolutions that the
        mask decoder applies to levels 0 and 1 (its `conv_s0`, `conv_s1`),
        applied here, so that the graph returns the convolved levels and
        holds no 256-channel high-resolution level. `vision_features` is
        the last level itself. The site's key holds the addresses of the two
        convolutions' parameters, which this module does not own: a move of
        the decoder alone drops the graph."""
        impls = tuple(blk.attn.attention_impl for blk in self.trunk.blocks)
        convs = (() if high_res is None else
                 tuple(p.data_ptr() for c in high_res for p in c.parameters()))
        levels = self._graph(lambda x: self._levels(x, high_res), sample,
                             key=(high_res is not None, impls, convs))
        return {"vision_features": levels[-1], "backbone_fpn": list(levels)}

    def _levels(self, sample, high_res):
        features = self.neck(self.trunk(sample))
        if self.scalp > 0:
            features = features[:-self.scalp]
        if high_res is not None:
            features[0] = conv1x1(high_res[0], features[0])
            features[1] = conv1x1(high_res[1], features[1])
        return tuple(features)
