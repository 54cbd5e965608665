"""The system under test: `no_time_to_train_tpu_torch`'s `NoAMGMatcher`,
built from a configuration file with weights that the benchmark makes from
the seed.

The weights are drawn on the device in one call of a `torch.Generator` in
bfloat16, the type the configurations serve in, then set leaf by leaf by
the rule of the program's own seeded init (norm scales and layer scales 1,
biases 0, embeddings and the random-Fourier matrix standard normal, other
weights normal / sqrt(fan_in)). The names and shapes are those of the
reference checkpoints (SAM2's `.pt`, HF `Dinov2Model` or `DINOv3ViTModel`),
read from the modules that the program's own `NoAMGMatcher` builds on the
meta device: its choice of encoder module by the preset's family (and, for
DINOv3, its gating rule) is the one the weights follow, so a new preset
reaches the benchmark through the program. The host keeps float32 copies:
the matcher loads them, and the reference reads the same values after the
measured window.
"""
import dataclasses
import math

import torch
import torch.nn as nn

__all__ = ["program_configs", "make_weights", "build_matcher"]


def program_configs(config):
    """The program's SAM2 and encoder config objects: the presets the
    configuration names, with its overrides (the CPU tests' tiny sizes)."""
    from no_time_to_train_tpu_torch.config.presets import (
        ENCODER_PRESETS, SAM2_PRESETS)
    prog = config["program"]
    sam2 = dataclasses.replace(SAM2_PRESETS[prog["sam2_cfg"]],
                               **prog.get("sam2_overrides", {}))
    enc = dataclasses.replace(ENCODER_PRESETS[prog["encoder_cfg"]],
                              **prog.get("encoder_overrides", {}))
    return sam2, enc


def _leaf_rules(model):
    """(name, shape, rule) of every state_dict entry: "one", "zero",
    "normal" or a standard deviation."""
    embeddings = {name + ".weight" for name, mod in model.named_modules()
                  if isinstance(mod, nn.Embedding)}
    out = []
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            rule = "zero"
        elif t.dim() == 1:
            rule = "one"
        elif name in embeddings or leaf.endswith("gaussian_matrix"):
            rule = "normal"
        else:
            rule = 1.0 / math.sqrt(max(1, math.prod(t.shape[1:])))
        out.append((name, tuple(t.shape), rule))
    return out


def _matching(config, overrides=None):
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        MatchingConfig)
    fields = {f.name for f in dataclasses.fields(MatchingConfig)}
    opts = {k: v for k, v in config["matching"].items() if k in fields}
    opts.update(overrides or {})
    return MatchingConfig(**opts)


def _spec(config):
    """(SAM2's, the encoder's) leaf rules in state-dict order, from the
    modules that `NoAMGMatcher` builds for the configuration, on the meta
    device and in the reference's layout (`encoder_quant` "none")."""
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        NoAMGMatcher)

    class MetaMatcher(NoAMGMatcher):
        def _build(self, cls, cfg, state_dict, seed):
            with torch.device("meta"):
                return cls(cfg)

    sam2_cfg, enc_cfg = program_configs(config)
    bank = config["bank"]
    m = MetaMatcher(sam2_cfg, enc_cfg,
                    _matching(config, {"encoder_quant": "none"}),
                    n_classes=bank["classes"], memory_length=bank["shots"],
                    device="meta")
    return _leaf_rules(m.sam2), _leaf_rules(m.dino)


@torch.no_grad()
def make_weights(config, seed, device):
    """-> (sam2 state dict, dino state dict) of float32 host tensors whose
    values are bfloat16 numbers drawn on `device` from `seed`."""
    specs = _spec(config)
    total = sum(math.prod(s) for spec in specs for _, s, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(total, generator=gen, device=device,
                      dtype=torch.bfloat16)
    views, off = [], 0
    for spec in specs:
        for name, shape, rule in spec:
            n = math.prod(shape)
            v = buf[off:off + n]
            if rule == "one":
                v.fill_(1.0)
            elif rule == "zero":
                v.zero_()
            elif rule != "normal":
                v.mul_(rule)
            views.append((name, shape, off, n))
            off += n
    host = buf.float().cpu()
    del buf
    out, i = [], 0
    for spec in specs:
        sd = {}
        for _ in spec:
            name, shape, o, n = views[i]
            sd[name] = host[o:o + n].view(shape)
            i += 1
        out.append(sd)
    return tuple(out)


def build_matcher(config, sam2_sd, dino_sd, device, overrides=None):
    """`NoAMGMatcher` with the configuration's matching options (and
    `overrides` of them: the control's `encoder_quant`)."""
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        NoAMGMatcher)
    sam2_cfg, enc_cfg = program_configs(config)
    bank = config["bank"]
    return NoAMGMatcher(sam2_cfg, enc_cfg, _matching(config, overrides),
                        n_classes=bank["classes"], memory_length=bank["shots"],
                        sam2_state_dict=sam2_sd, dino_state_dict=dino_sd,
                        device=device)
