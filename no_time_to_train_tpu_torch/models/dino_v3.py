"""DINOv3 ViT feature extractor (port of `no_time_to_train_tpu/models/dino_v3.py`).

Parameter names are those of HF `transformers.DINOv3ViTModel`, so its
state_dict loads unchanged; a q/k/v/o projection saved without a bias loads
with a zero bias, as the JAX converter does. CLS + register tokens + patches
with no learned position embedding; 2-D RoPE over the patch-centre
coordinates in [-1, 1] (half-split rotation, prefix tokens not rotated) in
q's dtype; LayerScale on both branches; a plain or gated MLP. Input is NHWC.
`quant="int8"` builds the q / k / v / o projections and the MLP's gate / up
/ down as W8A8 layers (ops/quant.py), as the JAX package's `quant`.
"""
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from no_time_to_train_tpu_torch.models.sam2.common import LayerNorm, _gelu_act
from no_time_to_train_tpu_torch.ops.attention import sdpa_bnhd
from no_time_to_train_tpu_torch.ops.quant import linear_cls

__all__ = ["DinoV3", "uses_gated_mlp"]


def uses_gated_mlp(cfg):
    """The JAX matcher's rule for the gated MLP (the '+' and huge models)."""
    return "plus" in cfg.hf_model_name or "huge" in cfg.name


@lru_cache(maxsize=None)
def _rope_tables_np(num_h, num_w, head_dim, theta):
    """cos / sin tables [num_h * num_w, head_dim] in float32, as the JAX
    package builds them."""
    coords_h = np.arange(0.5, num_h) / num_h
    coords_w = np.arange(0.5, num_w) / num_w
    hh, ww = np.meshgrid(coords_h, coords_w, indexing="ij")
    coords = np.stack([hh.reshape(-1), ww.reshape(-1)], axis=-1)  # [N, 2]
    coords = 2.0 * coords - 1.0
    inv_freq = 1.0 / theta ** np.arange(0, 1, 4 / head_dim)       # [D / 4]
    angles = 2 * np.pi * coords[:, :, None] * inv_freq[None, None, :]
    angles = np.tile(angles.reshape(len(coords), -1), 2)          # [N, D]
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


class _Attention(nn.Module):
    def __init__(self, d, heads, n_prefix, rope_theta, quant):
        super().__init__()
        lin = linear_cls(quant)
        self.q_proj = lin(d, d)
        self.k_proj = lin(d, d)
        self.v_proj = lin(d, d)
        self.o_proj = lin(d, d)
        self.heads, self.n_prefix, self.rope_theta = heads, n_prefix, rope_theta
        self.attention_impl = "pallas"
        self._tables = {}

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            w = state_dict.get(f"{prefix}{name}.weight")
            if w is not None and f"{prefix}{name}.bias" not in state_dict:
                state_dict[f"{prefix}{name}.bias"] = torch.zeros(
                    w.shape[0], dtype=torch.as_tensor(w).dtype)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _rope(self, grid_hw, head_dim, like):
        """cos, sin [1, N, 1, D] in like's dtype on like's device."""
        key = (grid_hw, head_dim, like.dtype, like.device)
        if key not in self._tables:
            cos, sin = _rope_tables_np(grid_hw[0], grid_hw[1], head_dim,
                                       self.rope_theta)
            self._tables[key] = tuple(
                torch.as_tensor(t).to(device=like.device, dtype=like.dtype)
                [None, :, None, :] for t in (cos, sin))
        return self._tables[key]

    def forward(self, x, grid_hw):
        b, n, c = x.shape
        head_dim = c // self.heads
        cos, sin = self._rope(grid_hw, head_dim, x)
        npf = self.n_prefix

        def split_rope(t):
            t = t.reshape(b, n, self.heads, head_dim)
            patches = t[:, npf:]
            patches = patches * cos + _rotate_half(patches) * sin
            return torch.cat([t[:, :npf], patches], dim=1)

        out = sdpa_bnhd(split_rope(self.q_proj(x)), split_rope(self.k_proj(x)),
                        self.v_proj(x).reshape(b, n, self.heads, head_dim),
                        self.attention_impl)
        return self.o_proj(out.reshape(b, n, c))


class _LayerScale(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.ones(d))


class _MLP(nn.Module):
    def __init__(self, d, hidden, gated, quant):
        super().__init__()
        lin = linear_cls(quant)
        if gated:
            self.gate_proj = lin(d, hidden)
        self.up_proj = lin(d, hidden)
        self.down_proj = lin(hidden, d)
        self.gated = gated

    def forward(self, x):
        if self.gated:
            return self.down_proj(_gelu_act(self.gate_proj(x)) * self.up_proj(x))
        return self.down_proj(_gelu_act(self.up_proj(x)))


class _Layer(nn.Module):
    def __init__(self, d, heads, n_prefix, gated, rope_theta, mlp_ratio=4,
                 quant="none"):
        super().__init__()
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.attention = _Attention(d, heads, n_prefix, rope_theta, quant)
        self.layer_scale1 = _LayerScale(d)
        self.norm2 = LayerNorm(d, eps=1e-5)
        self.mlp = _MLP(d, mlp_ratio * d, gated, quant)
        self.layer_scale2 = _LayerScale(d)

    def forward(self, x, grid_hw):
        h = self.attention(self.norm1(x), grid_hw)
        x = x + h * self.layer_scale1.lambda1.to(h.dtype)
        h = self.mlp(self.norm2(x))
        return x + h * self.layer_scale2.lambda1.to(h.dtype)


class _Embeddings(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg.feat_dim
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, d))   # checkpoint only
        self.register_tokens = nn.Parameter(
            torch.zeros(1, cfg.num_register_tokens, d))
        self.patch_embeddings = nn.Conv2d(3, d, cfg.patch_size,
                                          stride=cfg.patch_size)


class DinoV3(nn.Module):
    """DINOv3 ViT (small to huge); `use_gated_mlp` as `uses_gated_mlp`."""

    def __init__(self, cfg, use_gated_mlp=False, rope_theta=100.0,
                 quant="none"):
        super().__init__()
        if cfg.family != "dinov3":
            raise ValueError(f"{cfg.name} is not a DINOv3 configuration")
        self.cfg = cfg
        n_prefix = 1 + cfg.num_register_tokens
        self.embeddings = _Embeddings(cfg)
        self.layer = nn.ModuleList(
            _Layer(cfg.feat_dim, cfg.num_heads, n_prefix, use_gated_mlp,
                   rope_theta, quant=quant) for _ in range(cfg.depth))
        self.norm = LayerNorm(cfg.feat_dim, eps=1e-5)

    def forward(self, imgs, drop_prefix_tokens=True):
        """imgs: [B, S, S, 3] normalized. Returns patch features
        [B, grid*grid, D] (CLS and registers dropped when asked)."""
        c = self.cfg
        emb = self.embeddings
        b, s = imgs.shape[:2]
        grid = s // c.patch_size
        proj = emb.patch_embeddings
        x = F.conv2d(imgs.permute(0, 3, 1, 2).to(proj.weight.dtype),
                     proj.weight, proj.bias, stride=c.patch_size)
        x = x.flatten(2).transpose(1, 2)                 # [B, grid^2, D]
        prefix = torch.cat([emb.cls_token, emb.register_tokens], dim=1)
        x = torch.cat([prefix.expand(b, -1, -1).to(x.dtype), x], dim=1)
        for layer in self.layer:
            x = layer(x, (grid, grid))
        x = self.norm(x)
        return x[:, 1 + c.num_register_tokens:] if drop_prefix_tokens else x
