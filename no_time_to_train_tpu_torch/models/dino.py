"""DINOv2 ViT feature extractor (port of `no_time_to_train_tpu/models/dino.py`).

Parameter names are those of HF `transformers.Dinov2Model`, so its
state_dict loads unchanged. Input is NHWC; the patch embedding runs on the
NCHW view. `quant="int8"` builds the layers' query, key, value, output,
fc1 / fc2 and SwiGLU weights_in / weights_out as W8A8 layers
(ops/quant.py), as the JAX package's `quant`.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from no_time_to_train_tpu_torch.models.sam2.common import LayerNorm, _gelu_act
from no_time_to_train_tpu_torch.ops.attention import sdpa_bnhd
from no_time_to_train_tpu_torch.ops.quant import linear_cls
from no_time_to_train_tpu_torch.ops.resize import resize

__all__ = ["DinoV2"]


class _PatchEmbeddings(nn.Module):
    def __init__(self, patch, dim):
        super().__init__()
        self.projection = nn.Conv2d(3, dim, patch, stride=patch)


class _Embeddings(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg.feat_dim
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.mask_token = nn.Parameter(torch.zeros(1, d))   # checkpoint only
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, 1 + cfg.grid_size ** 2, d))
        self.patch_embeddings = _PatchEmbeddings(cfg.patch_size, d)


class _SelfAttention(nn.Module):
    def __init__(self, d, quant):
        super().__init__()
        lin = linear_cls(quant)
        self.query = lin(d, d)
        self.key = lin(d, d)
        self.value = lin(d, d)


class _SelfOutput(nn.Module):
    def __init__(self, d, quant):
        super().__init__()
        self.dense = linear_cls(quant)(d, d)


class _Attention(nn.Module):
    def __init__(self, d, heads, quant):
        super().__init__()
        self.attention = _SelfAttention(d, quant)
        self.output = _SelfOutput(d, quant)
        self.heads = heads
        self.attention_impl = "pallas"

    def forward(self, x):
        b, n, c = x.shape
        a = self.attention

        def split(t):
            return t.reshape(b, n, self.heads, -1)

        out = sdpa_bnhd(split(a.query(x)), split(a.key(x)), split(a.value(x)),
                        self.attention_impl)
        return self.output.dense(out.reshape(b, n, c))


class _LayerScale(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.ones(d))


class _MLP(nn.Module):
    def __init__(self, d, hidden, quant):
        super().__init__()
        lin = linear_cls(quant)
        self.fc1 = lin(d, hidden)
        self.fc2 = lin(hidden, d)

    def forward(self, x):
        return self.fc2(_gelu_act(self.fc1(x)))


class _SwiGLU(nn.Module):
    """HF Dinov2SwiGLUFFN (the giant): one `weights_in` to twice the hidden
    width (4 d * 2/3, rounded up to a multiple of 8), silu(x1) * x2, then
    `weights_out`."""

    def __init__(self, d, quant):
        super().__init__()
        hidden = (int(d * 4 * 2 / 3) + 7) // 8 * 8
        lin = linear_cls(quant)
        self.weights_in = lin(d, 2 * hidden)
        self.weights_out = lin(hidden, d)

    def forward(self, x):
        x1, x2 = self.weights_in(x).chunk(2, dim=-1)
        return self.weights_out(F.silu(x1) * x2)


class _Layer(nn.Module):
    """One block; without `layer_scale` (init_values None) the branches
    enter the residual unscaled and the block has no lambda1 parameters,
    as the JAX package's `use_layer_scale=False`."""

    def __init__(self, d, heads, ffn_layer="mlp", mlp_ratio=4,
                 layer_scale=True, quant="none"):
        super().__init__()
        self.norm1 = LayerNorm(d, eps=1e-6)
        self.attention = _Attention(d, heads, quant)
        self.layer_scale1 = _LayerScale(d) if layer_scale else None
        self.norm2 = LayerNorm(d, eps=1e-6)
        self.mlp = (_SwiGLU(d, quant) if ffn_layer == "swiglu"
                    else _MLP(d, mlp_ratio * d, quant))
        self.layer_scale2 = _LayerScale(d) if layer_scale else None

    def forward(self, x):
        h = self.attention(self.norm1(x))
        if self.layer_scale1 is not None:
            h = h * self.layer_scale1.lambda1
        x = x + h
        h = self.mlp(self.norm2(x))
        if self.layer_scale2 is not None:
            h = h * self.layer_scale2.lambda1
        return x + h


class _Encoder(nn.Module):
    def __init__(self, cfg, quant):
        super().__init__()
        self.layer = nn.ModuleList(
            _Layer(cfg.feat_dim, cfg.num_heads, cfg.ffn_layer,
                   layer_scale=cfg.init_values is not None, quant=quant)
            for _ in range(cfg.depth))


class DinoV2(nn.Module):
    """DINOv2: the MLP feed-forward (small to large) or the SwiGLU one
    (giant), with layer scale, or without it where init_values is None."""

    def __init__(self, cfg, quant="none"):
        super().__init__()
        if cfg.ffn_layer not in ("mlp", "swiglu") or cfg.family != "dinov2":
            raise NotImplementedError(
                f"{cfg.name}: only DINOv2 with MLP or SwiGLU blocks is "
                "ported")
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg, quant)
        self.layernorm = LayerNorm(cfg.feat_dim, eps=1e-6)

    def forward(self, imgs, drop_prefix_tokens=True):
        """imgs: [B, S, S, 3] normalized. Returns patch features
        [B, grid*grid, D] (the CLS token dropped when asked)."""
        c = self.cfg
        emb = self.embeddings
        b, s = imgs.shape[:2]
        grid = s // c.patch_size
        proj = emb.patch_embeddings.projection
        x = F.conv2d(imgs.permute(0, 3, 1, 2).to(proj.weight.dtype),
                     proj.weight, proj.bias, stride=c.patch_size)
        x = x.flatten(2).transpose(1, 2)                 # [B, grid^2, D]
        pos = emb.position_embeddings[0]
        if grid != c.grid_size:
            patch_pos = pos[1:].reshape(c.grid_size, c.grid_size, -1)
            patch_pos = resize(patch_pos[None].float(), (grid, grid),
                               mode="bicubic", antialias=True)[0]
            pos = torch.cat([pos[:1], patch_pos.reshape(grid * grid, -1)
                             .to(pos.dtype)], dim=0)
        x = torch.cat([emb.cls_token.expand(b, 1, -1), x], dim=1)
        x = x + pos[None].to(x.dtype)
        for layer in self.encoder.layer:
            x = layer(x)
        x = self.layernorm(x)
        return x[:, 1 + c.num_register_tokens:] if drop_prefix_tokens else x
