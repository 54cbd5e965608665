"""Seeded random weights for models that have no checkpoint."""
import math

import torch
import torch.nn as nn

from no_time_to_train_tpu_torch.models.sam2.common import LayerNorm

__all__ = ["init_random_"]


@torch.no_grad()
def init_random_(model, generator):
    """Fill every parameter from `generator` (on the parameters' device):
    LayerNorm scales and layer scales (`lambda1`, `gamma`) 1, biases 0, embeddings and the
    random-Fourier matrix standard normal (their reference init), other
    weights normal / sqrt(fan_in), fan_in being the product of all but the
    leading axis."""
    special = {}
    for mod in model.modules():
        if isinstance(mod, LayerNorm):
            special[id(mod.weight)] = "one"
        elif isinstance(mod, nn.Embedding):
            special[id(mod.weight)] = "normal"
    for name, p in model.named_parameters():
        rule = special.get(id(p))
        leaf = name.rsplit(".", 1)[-1]
        if rule == "one" or leaf in ("lambda1", "gamma"):
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        else:
            std = 1.0 if (rule == "normal" or leaf.endswith("gaussian_matrix")) \
                else 1.0 / math.sqrt(max(1, math.prod(p.shape[1:])))
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device, dtype=p.dtype) * std)
    return model
