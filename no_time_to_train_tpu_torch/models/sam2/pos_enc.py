"""Sine and random-Fourier position encodings (port of
`no_time_to_train_tpu/models/sam2/pos_enc.py`; reference
sam2/modeling/position_encoding.py). Outputs are NHWC ([H, W, C])."""
import math
from functools import lru_cache

import numpy as np
import torch

__all__ = ["sine_pos_embed_2d", "random_pe_coords", "random_pe_grid"]


@lru_cache(maxsize=None)
def _sine_pos_embed_2d_np(h, w, num_pos_feats, temperature, normalize, scale):
    npf = num_pos_feats // 2
    y_embed = np.tile(np.arange(1, h + 1, dtype=np.float32)[:, None], (1, w))
    x_embed = np.tile(np.arange(1, w + 1, dtype=np.float32)[None, :], (h, 1))
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = np.arange(npf, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / npf)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack((np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])),
                     axis=3).reshape(h, w, -1)
    pos_y = np.stack((np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])),
                     axis=3).reshape(h, w, -1)
    return np.concatenate((pos_y, pos_x), axis=2)


def sine_pos_embed_2d(h, w, num_pos_feats, temperature=10000, normalize=True,
                      scale=None, dtype=torch.float32, device=None):
    """[H, W, C] sine position embedding."""
    if scale is None:
        scale = 2 * math.pi
    return torch.as_tensor(
        _sine_pos_embed_2d_np(h, w, num_pos_feats, temperature, normalize,
                              scale), dtype=dtype, device=device)


def random_pe_coords(coords01, gaussian_matrix):
    """Encode [..., 2] coordinates in [0, 1]; gaussian_matrix [2, F].
    Returns [..., 2F] (sin then cos)."""
    coords = 2.0 * coords01 - 1.0
    coords = coords @ gaussian_matrix.to(coords01.dtype)
    coords = 2.0 * np.pi * coords
    return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


def random_pe_grid(h, w, gaussian_matrix, dtype=torch.float32):
    """[H, W, C] dense encoding of the pixel centres of an h x w grid."""
    dev = gaussian_matrix.device
    y = (torch.arange(h, dtype=dtype, device=dev) + 0.5) / h
    x = (torch.arange(w, dtype=dtype, device=dev) + 0.5) / w
    grid = torch.stack(torch.meshgrid(x, y, indexing="xy"), dim=-1)
    return random_pe_coords(grid, gaussian_matrix)
