"""Prompt encoder, points path (port of
`no_time_to_train_tpu/models/sam2/prompt_encoder.py`; reference
sam2/modeling/sam/prompt_encoder.py), NHWC.

The mask-prompt convolutions are held for checkpoint compatibility; the
slice prompts with points only.
"""
import torch
import torch.nn as nn

from no_time_to_train_tpu_torch.models.sam2.common import LayerNorm2d
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

    def embed_points(self, points, labels):
        """points [B, N, 2] (x, y) in input pixels, labels [B, N] int.
        Appends the padding point, as the reference does without boxes.
        Returns the sparse embeddings [B, N+1, C]."""
        dt = self.no_mask_embed.weight.dtype
        points = points.float() + 0.5
        b = points.shape[0]
        points = torch.cat([points, points.new_zeros(b, 1, 2)], dim=1)
        labels = torch.cat([labels, -labels.new_ones(b, 1)], dim=1)
        h, w = self.input_image_size
        coords01 = torch.stack([points[..., 0] / w, points[..., 1] / h], -1)
        pe = random_pe_coords(coords01, self._gaussian)
        not_a_point = (labels == -1)[..., None]
        pe = torch.where(not_a_point, torch.zeros_like(pe), pe)
        point_w = torch.cat([e.weight for e in self.point_embeddings]).to(pe.dtype)
        onehot = torch.stack([(labels == i).to(pe.dtype) for i in range(4)],
                             dim=-1)
        pe = pe + onehot @ point_w
        pe = pe + not_a_point * self.not_a_point_embed.weight[0].to(pe.dtype)
        return pe.to(dt)
