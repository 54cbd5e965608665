"""The operation and byte counts of `portbench/counts/` against values
worked by hand, and against torch's FLOP counter over the plain reference
on the meta device (no arithmetic runs)."""
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import dinov3_block
from portbench.counts import common
from portbench.reference import models

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cfg(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def test_k4_per_chunk():
    """K4 on a chunk of 256 prompts at Hiera's 64 x 64 embedding, C 256:
    2 x 4096 x 256 x 256 (first transposed conv) + 2 x 16384 x 64 x 128
    (second) + 2 x 65536 x 32 (product) = 809.5 M a prompt, 207.2 G a
    chunk; bound 0.2095 ms by operations at 989 TFLOP/s (PERF.md's kernel
    table)."""
    ops, nbytes = common.upscale_call(256, 4096, 256)
    per_prompt = 2 * 4096 * 256 * 256 + 2 * 16384 * 64 * 128 + 2 * 65536 * 32
    assert ops == 256 * per_prompt == 207_232_172_032
    assert abs(ops / 989e12 * 1e3 - 0.2095) < 1e-4
    assert nbytes / 3.35e12 < ops / 989e12


def test_window_stage1_bound():
    """Kernel 10 at Hiera-L's stage 1: 65536 tokens, width 144, windows of
    64: bytes 2 x 4 x 65536 x 144 bound it at 0.0225 ms."""
    ops, nbytes = common.window_call(65536, 144, 64)
    assert ops == 4 * 65536 * 64 * 144
    assert nbytes == 8 * 65536 * 144
    assert abs(nbytes / 3.35e12 * 1e3 - 0.0225) < 1e-4


@pytest.mark.parametrize("name,first,per_block", [
    # stage-1 block of Hiera-L: 24 T d^2 + 4 T w^2 d, T 65536, d 144, w 8
    ("sam2l_dinov2l", 0, 24 * 65536 * 144 ** 2 + 4 * 65536 * 64 * 144),
    # stage-3 window block of Hiera-L: T 4096, d 576, windows of 16 x 16
    ("sam2l_dinov2l", 9, 24 * 4096 * 576 ** 2 + 4 * 4096 * 256 * 576),
    # a global block of Hiera-L (23): all 4096 tokens attend to all
    ("sam2l_dinov2l", 23, 24 * 4096 * 576 ** 2 + 4 * 4096 * 4096 * 576),
    # Hiera-S stage 3, windows of 14 on 64 x 64, padded to 5 x 5 windows
    # of 196: qkv, attention and output projection on the 4900 padded
    # tokens, the MLP on the 4096 real ones
    ("sam2s_dinov2l", 4, 8 * 4900 * 384 ** 2 + 16 * 4096 * 384 ** 2
     + 4 * 4900 * 196 * 384),
    # Hiera-S stage-1 block: d 96, windows of 8
    ("sam2s_dinov2l", 0, 24 * 65536 * 96 ** 2 + 4 * 65536 * 64 * 96),
])
def test_hiera_block(name, first, per_block):
    hiera = _cfg(name)["topology"]["hiera"]
    got = common.hiera_block_flops(hiera)[first]
    assert got == per_block


def _meta_sd(model_fn, *args):
    """Run `model_fn` under the FLOP counter with every weight on the meta
    device, shaped as the program's state dict."""
    counter = FlopCounterMode(display=False)
    with counter:
        model_fn(*args)
    return counter.get_total_flops()


def _meta_weights(cfg):
    from portbench.harness.program import _spec
    specs = _spec(cfg)
    return [{n: torch.empty(s, device="meta") for n, s, _ in spec}
            for spec in specs]


@pytest.mark.parametrize("name", ["sam2l_dinov2l", "sam2s_dinov2l"])
def test_encoders_against_flop_counter(name):
    cfg = _cfg(name)
    t = cfg["topology"]
    sam2_sd, dino_sd = _meta_weights(cfg)
    e = t["dino"]["img_size"]
    got = _meta_sd(models.dino_features, dino_sd, t["dino"],
                   torch.empty(1, e, e, 3, device="meta"))
    assert got == common.dino_flops(t["dino"])
    s = t["hiera"]["image_size"]
    got = _meta_sd(models.image_encoder, sam2_sd, t["hiera"],
                   torch.empty(1, s, s, 3, device="meta"))
    assert got == common.hiera_flops(t["hiera"])


@pytest.mark.parametrize("preset,block", [
    ("dinov3_large", dinov3_block(1024, 24, 16, 4096, False)),
    ("dinov3_huge", dinov3_block(1280, 32, 20, 5120, True, "silu"))])
def test_dinov3_against_flop_counter(preset, block):
    """DINOv3 at its published widths and 592^2: the count against torch's
    FLOP counter over the reference, on the weights that the program's
    matcher would hold for the preset."""
    cfg = _cfg("sam2l_dinov2l")
    cfg["program"]["encoder_cfg"] = preset
    cfg["topology"]["dino"] = block
    _, dino_sd = _meta_weights(cfg)
    got = _meta_sd(models.dino_features, dino_sd, block,
                   torch.empty(1, 592, 592, 3, device="meta"))
    assert got == common.dino_flops(block)


def test_dinov3_7b_by_hand():
    """DINOv3 ViT-7B/16 at 592^2: 37^2 patches + CLS + 4 registers = 1374
    tokens, D 4096, 32 heads, SwiGLU of width 8192, 40 layers: per layer
    8 n D^2 = 184.4 G, 4 n^2 D = 30.9 G, 6 n D H = 276.6 G; 19.69 T an
    image with the patch projection."""
    b = dinov3_block(4096, 40, 32, 8192, True, "silu")
    n, d, h = 1374, 4096, 8192
    layer = 8 * n * d * d + 4 * n * n * d + 6 * n * d * h
    assert round(8 * n * d * d / 1e9, 1) == 184.4
    assert round(4 * n * n * d / 1e9, 1) == 30.9
    assert round(6 * n * d * h / 1e9, 1) == 276.6
    assert common.dino_flops(b) == 40 * layer + 2 * 37 ** 2 * 3 * 16 ** 2 * d
    assert round(common.dino_flops(b) / 1e12, 2) == 19.69


def test_decoder_against_flop_counter():
    """The reference decodes every prompt against its own copy of the
    image embedding, so it also does the layer-0 projections that the
    count takes once per image: 6 hw C Ci for each further prompt."""
    cfg = _cfg("sam2l_dinov2l")
    t = cfg["topology"]
    sam2_sd, _ = _meta_weights(cfg)
    p, c = 64, t["decoder"]["dim"]
    side = t["hiera"]["image_size"] // 16
    feats = [torch.empty(1, 4 * side, 4 * side, c // 8, device="meta"),
             torch.empty(1, 2 * side, 2 * side, c // 4, device="meta"),
             torch.empty(1, side, side, c, device="meta")]
    got = _meta_sd(models.decode_best, sam2_sd, t["decoder"], feats,
                   torch.empty(side, side, c, device="meta"),
                   torch.empty(p, 2, c, device="meta"))
    hw, ci = side * side, c // t["decoder"]["downsample"]
    want = common.decoder_flops(t["decoder"], t["hiera"]["image_size"], p)
    assert got == want + (p - 1) * 6 * hw * c * ci


def test_image_totals():
    """Per image: about 5.86 TFLOP on Hiera-L + DINOv2-L, 4.39 on Hiera-S
    (DINOv2-L 1.01, Hiera-L 1.82 / Hiera-S 0.35, the decode 2.89, the
    scoring 0.14)."""
    big = common.image_flops(_cfg("sam2l_dinov2l"))
    small = common.image_flops(_cfg("sam2s_dinov2l"))
    assert 5.8e12 < big < 5.9e12
    assert 4.35e12 < small < 4.45e12
