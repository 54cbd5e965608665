"""Prompt encoder (port of
`no_time_to_train_tpu/models/sam2/prompt_encoder.py`; reference
sam2/modeling/sam/prompt_encoder.py), NHWC.

Points carry labels 1 / 0 (positive / negative click), 2 / 3 (the two
corners of a box) and -1 (the padding point); a box prompt is its two
corners with labels 2 and 3; a mask prompt goes through the
`mask_downscaling` convolutions.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from no_time_to_train_tpu_torch.models.sam2.common import (
    LayerNorm2d, _gelu_act, conv1x1)
from no_time_to_train_tpu_torch.models.sam2.pos_enc import (
    random_pe_coords, random_pe_grid)

__all__ = ["PromptEncoder"]


class _PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(
            torch.randn(2, num_pos_feats), requires_grad=False)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim, image_embedding_size, input_image_size,
                 mask_in_chans=16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = _PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(
            nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, stride=2),
            LayerNorm2d(mask_in_chans // 4), nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, stride=2),
            LayerNorm2d(mask_in_chans), nn.GELU(),
            nn.Conv2d(mask_in_chans, embed_dim, 1))

    @property
    def _gaussian(self):
        return self.pe_layer.positional_encoding_gaussian_matrix

    def get_dense_pe(self):
        """[h, w, C] encoding of the image-embedding grid."""
        h, w = self.image_embedding_size
        dt = self.no_mask_embed.weight.dtype
        return random_pe_grid(h, w, self._gaussian).to(dt)

    def no_mask_dense(self):
        """The no-mask dense embedding at batch 1: [1, h, w, C]."""
        h, w = self.image_embedding_size
        return self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
            1, h, w, self.embed_dim)

    def embed_points(self, points, labels, pad=True):
        """points [B, N, 2] (x, y) in input pixels, labels [B, N] int.
        With `pad`, appends the padding point, as the reference does
        without boxes. Returns the sparse embeddings [B, N (+1), C]."""
        dt = self.no_mask_embed.weight.dtype
        points = points.float() + 0.5
        if pad:
            b = points.shape[0]
            points = torch.cat([points, points.new_zeros(b, 1, 2)], dim=1)
            labels = torch.cat([labels, -labels.new_ones(b, 1)], dim=1)
        pe = random_pe_coords(self._coords01(points), self._gaussian)
        not_a_point = (labels == -1)[..., None]
        pe = torch.where(not_a_point, torch.zeros_like(pe), pe)
        point_w = torch.cat([e.weight for e in self.point_embeddings]).to(pe.dtype)
        onehot = torch.stack([(labels == i).to(pe.dtype) for i in range(4)],
                             dim=-1)
        pe = pe + onehot @ point_w
        pe = pe + not_a_point * self.not_a_point_embed.weight[0].to(pe.dtype)
        return pe.to(dt)

    def embed_boxes(self, boxes):
        """boxes [B, 4] XYXY in input pixels -> the two corner embeddings
        [B, 2, C] (labels 2 and 3)."""
        dt = self.no_mask_embed.weight.dtype
        corners = (boxes.float() + 0.5).reshape(-1, 2, 2)
        pe = random_pe_coords(self._coords01(corners), self._gaussian)
        corner_w = torch.cat([self.point_embeddings[2].weight,
                              self.point_embeddings[3].weight]).to(pe.dtype)
        return (pe + corner_w).to(dt)

    def _coords01(self, points):
        h, w = self.input_image_size
        return torch.stack([points[..., 0] / w, points[..., 1] / h], -1)

    def embed_masks(self, masks):
        """masks [B, 4h, 4w, 1] -> dense embeddings [B, h, w, C]."""
        seq = self.mask_downscaling
        x = masks.to(seq[0].weight.dtype).permute(0, 3, 1, 2)
        for conv, norm in ((seq[0], seq[1]), (seq[3], seq[4])):
            x = F.conv2d(x, conv.weight, conv.bias, stride=conv.stride)
            x = _gelu_act(norm(x.permute(0, 2, 3, 1))).permute(0, 3, 1, 2)
        return conv1x1(seq[6], x.permute(0, 2, 3, 1))

    def forward(self, points=None, boxes=None, masks=None):
        """points: (coords [B, P, 2], labels [B, P]); boxes [B, 4];
        masks [B, 4h, 4w, 1]. The sparse tokens are the points (and the
        padding point where there is no box), then the box corners.
        Returns (sparse [B, N, C], dense [B, h, w, C])."""
        if points is not None:
            bs = points[0].shape[0]
        elif boxes is not None:
            bs = boxes.shape[0]
        else:
            bs = masks.shape[0] if masks is not None else 1
        sparse = [self.no_mask_embed.weight.new_zeros((bs, 0, self.embed_dim))]
        if points is not None:
            sparse.append(self.embed_points(*points, pad=boxes is None))
        if boxes is not None:
            sparse.append(self.embed_boxes(boxes))
        if masks is not None:
            dense = self.embed_masks(masks)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_dense().expand(bs, h, w, self.embed_dim)
        return torch.cat(sparse, dim=1), dense
