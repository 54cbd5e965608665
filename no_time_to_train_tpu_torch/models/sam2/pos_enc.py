"""Sine and random-Fourier position encodings and axial 2D RoPE (port of
`no_time_to_train_tpu/models/sam2/pos_enc.py`; reference
sam2/modeling/position_encoding.py). Spatial outputs are NHWC ([H, W, C]);
RoPE is expressed with real cos / sin rotations of (even, odd) pairs."""
import math
from functools import lru_cache

import numpy as np
import torch

from no_time_to_train_tpu_torch.ops.graph_inputs import held

__all__ = ["sine_pos_embed_2d", "sine_pos_table", "random_pe_coords",
           "random_pe_grid", "axial_rope_cos_sin", "apply_rotary",
           "sine_pe_1d"]


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


@lru_cache(maxsize=8)
def _sine_pos_tensor(h, w, num_pos_feats, dtype, device):
    return sine_pos_embed_2d(h, w, num_pos_feats, dtype=dtype, device=device)


def sine_pos_table(h, w, num_pos_feats, dtype=torch.float32, device=None):
    """`sine_pos_embed_2d` with the default temperature and scale, made and
    uploaded once per (h, w, features, dtype, device): a step that reads it
    copies nothing from the host (the caller must not modify the shared
    tensor)."""
    return held(_sine_pos_tensor(h, w, num_pos_feats, dtype,
                                 torch.device(device or "cpu")))


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


@lru_cache(maxsize=None)
def _axial_rope_np(dim, end_x, end_y, theta):
    freqs = 1.0 / (theta ** (np.arange(0, dim, 4)[: dim // 4]
                             .astype(np.float32) / dim))
    t = np.arange(end_x * end_y, dtype=np.float32)
    t_x, t_y = t % end_x, np.floor(t / end_x)
    ang = np.concatenate([np.outer(t_x, freqs), np.outer(t_y, freqs)],
                         axis=-1)                       # [N, dim / 2]
    return np.cos(ang), np.sin(ang)


@lru_cache(maxsize=8)
def _axial_rope_tensors(dim, end_x, end_y, theta, device):
    cos, sin = _axial_rope_np(dim, end_x, end_y, theta)
    return (torch.as_tensor(cos, dtype=torch.float32, device=device),
            torch.as_tensor(sin, dtype=torch.float32, device=device))


def axial_rope_cos_sin(dim, end_x, end_y, theta=10000.0, device=None):
    """float32 cos / sin tables [end_x * end_y, dim // 2] of the 2D axial
    RoPE, cached per device."""
    cos, sin = _axial_rope_tensors(dim, end_x, end_y, float(theta),
                                   torch.device(device or "cpu"))
    return held(cos), held(sin)


def apply_rotary(x, cos, sin, repeat_freqs=1):
    """Rotate the (even, odd) pairs of the last axis of x [..., N, D] by
    cos / sin [N0, D / 2], where N = N0 * repeat_freqs (the key repeat of
    the memory cross-attention). Computed in float32, returned in x's
    dtype."""
    xf = x.float()
    pair = xf.reshape(*xf.shape[:-1], -1, 2)
    xe, xo = pair[..., 0], pair[..., 1]
    if repeat_freqs > 1:
        cos, sin = cos.repeat(repeat_freqs, 1), sin.repeat(repeat_freqs, 1)
    out = torch.stack([xe * cos - xo * sin, xe * sin + xo * cos], dim=-1)
    return out.reshape(xf.shape).to(x.dtype)


def sine_pe_1d(pos, dim, temperature=10000):
    """Reference sam2_utils.get_1d_sine_pe: pos [...] -> [..., dim]."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / pe_dim)
    pos_embed = pos[..., None] / dim_t
    return torch.cat([torch.sin(pos_embed), torch.cos(pos_embed)], dim=-1)
