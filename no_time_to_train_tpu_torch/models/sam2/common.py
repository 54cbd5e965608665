"""Shared building blocks of the SAM2 stack (port of
`no_time_to_train_tpu/models/sam2/common.py`), NHWC layout.

Parameter names follow reference sam2/modeling/sam2_utils.py, so a SAM2
state_dict loads unchanged.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from no_time_to_train_tpu_torch.ops.fused_ln import (
    layer_norm, layer_norm_plain, ln_fusible)
from no_time_to_train_tpu_torch.ops.quant import linear_cls

__all__ = ["MLP", "LayerNorm", "LayerNorm2d", "_layer_norm", "_gelu_act",
           "conv1x1", "conv_transpose_2x2_s2"]


def _gelu_act(x):
    """Exact erf GELU in float32, tanh GELU in bf16 (the JAX package's
    encoder and decoder activations)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16
                  else "none")


ACT = {"relu": F.relu, "gelu": _gelu_act}


def _layer_norm(x, weight, bias, eps):
    """LayerNorm over the last axis: float32 statistics, normalize and affine
    in x's dtype. Large bf16 norms take kernel K1 (ops/fused_ln.py)."""
    if ln_fusible(x):
        return layer_norm(x.contiguous(), weight, bias, eps)
    return layer_norm_plain(x, weight, bias, eps)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis (population variance, eps inside the
    square root); weight and bias as torch's nn.LayerNorm."""

    def __init__(self, num_features, eps=1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.eps = eps

    def forward(self, x):
        return _layer_norm(x, self.weight, self.bias, self.eps)


class LayerNorm2d(LayerNorm):
    """Reference LayerNorm2d (channel norm, eps 1e-6) on NHWC tensors."""

    def __init__(self, num_channels, eps=1e-6):
        super().__init__(num_channels, eps)


class MLP(nn.Module):
    """Reference sam2_utils.MLP: `num_layers` Linear layers with the
    activation between them, optional sigmoid output; `quant="int8"` builds
    them as W8A8 layers (ops/quant.py; the Hiera blocks' MLPs under
    `encoder_quant`)."""

    def __init__(self, input_dim, hidden_dim, output_dim, num_layers,
                 activation="relu", sigmoid_output=False, quant="none"):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        lin = linear_cls(quant)
        self.layers = nn.ModuleList(
            lin(dims[i], dims[i + 1]) for i in range(num_layers))
        self.act = ACT[activation]
        self.sigmoid_output = sigmoid_output

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.act(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


def conv1x1(conv, x):
    """A 1x1 nn.Conv2d applied to an NHWC tensor, as a linear layer."""
    w = conv.weight
    return F.linear(x, w.reshape(w.shape[0], w.shape[1]), conv.bias)


def conv_transpose_2x2_s2(x, kernel, bias):
    """torch ConvTranspose2d(k=2, s=2) on an NHWC input, as one product
    [BHW, c_in] @ [c_in, 4*c_out] and a subpixel shuffle. kernel is in the
    torch layout [c_in, c_out, 2, 2]."""
    b, h, w, c_in = x.shape
    c_out = kernel.shape[1]
    kmat = kernel.permute(0, 2, 3, 1).reshape(c_in, 4 * c_out).to(x.dtype)
    t = (x.reshape(b * h * w, c_in) @ kmat).reshape(b, h, w, 2, 2, c_out)
    y = t.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c_out)
    return y + bias.to(x.dtype)
