"""DINOv3 ViT-7B/16 in the port (`config/presets.py` `dinov3_7b`,
`models/dino_v3.py`) and K1's gate at its width, on the CPU.

The port's `DinoV3` is held in float32 against the plain float32 reference of
the benchmark (`portbench/reference/models.dino_features`, written from the
published model; it imports neither the program nor JAX) at a tiny
configuration with the 7B's mechanisms: head dim 128, 4 registers, an MLP
whose width is not 4 x D, LayerScale not 1, gated or plain, SiLU or GELU.
The 7B itself is built on the meta device only. No JAX here."""
import dataclasses
import hashlib
import math
import os
import re

import pytest
import torch
import torch.nn.functional as F

from no_time_to_train_tpu_torch.config import yaml_lite
from no_time_to_train_tpu_torch.config.presets import (
    ENCODER_PRESETS, EncoderConfig)
from no_time_to_train_tpu_torch.models.dino import DinoV2
from no_time_to_train_tpu_torch.models.dino_v3 import (
    DinoV3, mlp_width, uses_gated_mlp)
from no_time_to_train_tpu_torch.models.sam2.common import _gelu_act
from no_time_to_train_tpu_torch.ops import fused_ln
from portbench.reference import models as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(gated, act):
    return EncoderConfig("tiny_7b", 64, 16, 256, 2, 2, "local",
                         num_register_tokens=4, family="dinov3",
                         mlp_hidden=512, mlp_act=act, gated_mlp=gated)


def _block(cfg):
    """The reference's topology block for an `EncoderConfig`."""
    return {"family": "dinov3", "img_size": cfg.img_size,
            "patch_size": cfg.patch_size, "dim": cfg.feat_dim,
            "depth": cfg.depth, "heads": cfg.num_heads,
            "registers": cfg.num_register_tokens,
            "mlp_hidden": mlp_width(cfg), "gated": uses_gated_mlp(cfg),
            "act": cfg.mlp_act, "rope_theta": 100.0, "eps": 1e-5}


def _draw(model, seed):
    """Every leaf from `seed`: norm scales near 1, layer scales in
    [0.5, 1.5], biases small, the rest normal / sqrt(fan_in)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "lambda1":
                p.copy_(0.5 + torch.rand(p.shape, generator=g))
            elif leaf == "weight" and p.dim() == 1:
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g))
            elif leaf == "bias":
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            else:
                fan_in = math.prod(p.shape[1:]) if p.dim() > 1 else 1
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(fan_in))
    return model


def _lambda_not_one(model):
    return all(not torch.all(p == 1) for n, p in model.named_parameters()
               if n.endswith("lambda1"))


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("gated", [True, False])
def test_matches_the_plain_reference(gated, act):
    """Float32 features of the port and of the reference on the same seeded
    weights: [2, 16, 256], prefix tokens dropped, heads of 128."""
    cfg = _tiny(gated, act)
    model = _draw(DinoV3(cfg), 7).eval()
    assert model.layer[0].attention.q_proj.weight.shape[0] // cfg.num_heads \
        == 128
    assert _lambda_not_one(model)
    imgs = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        got = model(imgs)
        want = ref.dino_features(model.state_dict(), _block(cfg), imgs)
    assert got.shape == want.shape == (2, 16, 256)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_reference_sees_the_activation():
    """The comparison above can fail: SiLU where the port computes GELU
    reads far outside its tolerance."""
    cfg = _tiny(True, "gelu")
    model = _draw(DinoV3(cfg), 9).eval()
    imgs = torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(10))
    with torch.no_grad():
        got = model(imgs)
        want = ref.dino_features(model.state_dict(),
                                 dict(_block(cfg), act="silu"), imgs)
    assert (got - want).abs().max() > 1e-2


def _meta(cfg):
    with torch.device("meta"):
        return (DinoV3(cfg, use_gated_mlp=uses_gated_mlp(cfg))
                if cfg.family == "dinov3" else DinoV2(cfg))


def test_7b_widths_and_parameters():
    """ViT-7B/16 as published: 40 blocks of 4096, 32 heads of 128, a SwiGLU
    of 8192, 4 registers, patch 16. Parameters: embeddings (CLS, mask token,
    4 registers, the 16 x 16 patch projection and its bias) 7 D + 768 D;
    per layer two norms and two layer scales 6 D, q, k, v, o with their
    (zero) biases 4 (D^2 + D), gate and up 2 (D H + H), down H D + D; the
    final norm 2 D: 6,716,526,592 (6.72 B)."""
    assert set(ENCODER_PRESETS) - set(EARLIER) == {"dinov3_7b"}
    cfg = ENCODER_PRESETS["dinov3_7b"]
    m = _meta(cfg)
    d, h, depth = 4096, 8192, 40
    assert (cfg.feat_dim, cfg.depth, cfg.num_heads, cfg.patch_size,
            cfg.img_size, cfg.num_register_tokens) == (d, depth, 32, 16, 592, 4)
    assert len(m.layer) == depth
    mlp = m.layer[0].mlp
    assert mlp.gated and mlp.act is F.silu
    assert mlp.gate_proj.weight.shape == mlp.up_proj.weight.shape == (h, d)
    assert mlp.down_proj.weight.shape == (d, h)
    assert m.layer[0].attention.q_proj.weight.shape == (d, d)
    assert m.embeddings.register_tokens.shape == (1, 4, d)
    assert m.embeddings.patch_embeddings.weight.shape == (d, 3, 16, 16)
    per_layer = 6 * d + 4 * (d * d + d) + 2 * (d * h + h) + h * d + d
    want = 7 * d + 3 * 16 * 16 * d + depth * per_layer + 2 * d
    assert want == 6_716_526_592
    assert sum(p.numel() for p in m.parameters()) == want


# the leaves (name, shape) of every earlier preset's module, as the matcher
# builds it, before the MLP's width, activation and gating became fields:
# sha1 of "name [shape]" lines, leaf count, parameter count
EARLIER = {
    "dinov2_small": ("44ac55deb2a53421f6b015df0969602ae9142363", 223, 22056576),
    "dinov2_base": ("36e3c8fea12306baf042e9f5cffa21620eaa0eb4", 223, 86580480),
    "dinov2_large": ("4f0c33397bcd21c39ee4241f7ab7b619d356181d", 439,
                     304368640),
    "dinov2_giant": ("2e1aa9675ed24d281ab96cab743ac59bd3641bf3", 727,
                     1136480768),
    "dinov3_small": ("9e8e59f95665a905bee945ebc94d2719e0cafdd6", 223, 21601152),
    "dinov3_base": ("0cf41bf51b8d79801a2f04868b8512442c95e9d1", 223, 85669632),
    "dinov3_large": ("ee28050acc59e12f8b3e38eda130ccf6cf98d91b", 439,
                     303154176),
    "dinov3_huge": ("4bcc4d346f9d38f5d71c329f6170e5b25efd69aa", 647,
                    840633600),
}


@pytest.mark.parametrize("name", sorted(EARLIER))
def test_earlier_presets_build_the_same_module(name):
    """Same leaf names and shapes as before; a DINOv3 MLP keeps its GELU
    (dinov3_huge's gate too)."""
    cfg = ENCODER_PRESETS[name]
    m = _meta(cfg)
    leaves = [(n, list(t.shape)) for n, t in m.state_dict().items()]
    text = "\n".join(f"{n} {s}" for n, s in leaves)
    assert (hashlib.sha1(text.encode()).hexdigest(), len(leaves),
            sum(math.prod(s) for _, s in leaves)) == EARLIER[name]
    if cfg.family == "dinov3":
        assert m.layer[0].mlp.act is _gelu_act


def test_ln_gate_admits_only_what_k1_takes():
    """`ln_fusible` admits exactly the widths K1 takes: 16 to 8192 in bf16
    (the wide-row kernel above 2048), nothing in other dtypes, and the
    limits equal the CUDA source's."""
    for dt in (torch.bfloat16, torch.float32, torch.float16):
        admitted = [c for c in range(1, 9001)
                    if fused_ln.ln_fusible(torch.empty(1024, c, dtype=dt,
                                                       device="meta"))]
        if dt == torch.bfloat16:
            assert admitted == list(range(16, 8193))
        else:
            assert admitted == []
        assert all(c <= fused_ln.max_cols(dt) for c in admitted)
    assert fused_ln.ln_fusible(torch.empty(1374, 4096, dtype=torch.bfloat16,
                                           device="meta"))
    with open(os.path.join(ROOT, "no_time_to_train_tpu_torch", "csrc",
                           "layer_norm.cu")) as f:
        src = f.read()
    wide = int(re.search(r"kMaxWideCols = (\d+);", src).group(1))
    lanes = int(re.search(r"kMaxPerLane = (\d+);", src).group(1))
    assert fused_ln.max_cols(torch.bfloat16) == wide == 8192
    assert fused_ln.max_cols(torch.float32) == 32 * lanes == 2048


def test_runner_yaml_names_the_7b():
    """The CLI's configuration of the cell: Hiera-L, the 7B preset, the
    1-shot bank of 20 classes."""
    path = os.path.join(ROOT, "configs",
                        "coco_fewshot_1shot_Sam2L_dinov3_7b.yaml")
    cfg = yaml_lite.load_file(path)["model"]["init_args"]
    model = cfg["model_cfg"]
    assert model["encoder_cfg"]["name"] == "dinov3_7b"
    assert model["sam2_cfg_file"] == "sam2_hiera_l.yaml"
    assert model["memory_bank_cfg"] == {"enable": True, "category_num": 20,
                                        "length": 1}
    assert cfg["dataset_cfgs"]["fill_memory"]["memory_length"] == 1
    assert dataclasses.asdict(ENCODER_PRESETS["dinov3_7b"])["mlp_act"] == \
        "silu"
