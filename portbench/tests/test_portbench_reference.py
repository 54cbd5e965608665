"""The plain float32 reference against the port's own CPU path (its plain
versions of every kernel) at the tiny preset, Hiera-T + DINOv2-S in
float32, and at tiny DINOv3 encoders, plain and gated, on the same seeded
weights: layer by layer, then the whole step through the benchmark's
comparison."""
import numpy as np
import pytest
import torch

from conftest import (TINY_DINOV3, run_tiny, tiny_config,
                      tiny_dinov3_config)
from portbench.harness import inputs
from portbench.harness.program import build_matcher, make_weights
from portbench.reference import matcher as ref
from portbench.reference import models


@pytest.fixture(scope="module")
def tiny(torch_threads):
    cfg = tiny_config()
    sam2_sd, dino_sd = make_weights(cfg, 11, torch.device("cpu"))
    matcher = build_matcher(cfg, sam2_sd, dino_sd, "cpu")
    return cfg, sam2_sd, dino_sd, matcher


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_dino_features(tiny):
    cfg, _, dino_sd, matcher = tiny
    e = cfg["topology"]["dino"]["img_size"]
    img = torch.rand(2, e, e, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = matcher.dino(matcher._normalize(img))
        want = models.dino_features(dino_sd, cfg["topology"]["dino"],
                                    ref.normalize(img))
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("kind", sorted(TINY_DINOV3))
def test_dinov3_features(torch_threads, kind):
    """The reference's DINOv3 (RoPE on the patch rows, registers, LayerScale,
    the plain or gated MLP) against the encoder that the program's matcher
    builds for the preset."""
    cfg = tiny_dinov3_config(kind)
    topo = cfg["topology"]["dino"]
    sam2_sd, dino_sd = make_weights(cfg, 13, torch.device("cpu"))
    matcher = build_matcher(cfg, sam2_sd, dino_sd, "cpu")
    assert type(matcher.dino).__name__ == "DinoV3"
    assert ("layer.0.mlp.gate_proj.weight" in dino_sd) == topo["gated"]
    e = topo["img_size"]
    img = torch.rand(2, e, e, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = matcher.dino(matcher._normalize(img))
        want = models.dino_features(dino_sd, topo, ref.normalize(img))
    assert got.shape == want.shape == (2, (e // 16) ** 2, topo["dim"])
    assert _rel(got, want) < 1e-5


def test_dinov3_rope_tables():
    """The RoPE angles of one patch worked by hand: a 2 x 2 grid, head dim
    8, theta 100: the patch at row 0, column 1 sits at (-0.5, 0.5); periods
    1 and 10; angles [h / 1, h / 10, w / 1, w / 10] x 2 pi, tiled twice."""
    cos, sin = models.rope_tables(2, 8, 100.0, torch.device("cpu"))
    h, w = -0.5, 0.5
    want = 2 * np.pi * np.array([h, h / 10, w, w / 10] * 2)
    assert np.allclose(cos[1].numpy(), np.cos(want), atol=1e-6)
    assert np.allclose(sin[1].numpy(), np.sin(want), atol=1e-6)


def test_image_encoder(tiny):
    cfg, sam2_sd, _, matcher = tiny
    s = cfg["topology"]["hiera"]["image_size"]
    img = torch.rand(1, s, s, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = matcher.sam2.forward_image(matcher._normalize(img))["backbone_fpn"]
        want = models.image_encoder(sam2_sd, cfg["topology"]["hiera"],
                                    ref.normalize(img))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) < 1e-5


def test_grid_decode(tiny):
    cfg, sam2_sd, _, matcher = tiny
    s = cfg["topology"]["hiera"]["image_size"]
    img = torch.rand(s, s, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        lr, iou, pts = matcher._decode_grid(img)
        feats = models.image_encoder(sam2_sd, cfg["topology"]["hiera"],
                                     ref.normalize(img[None]))
        pe = models.dense_pe(sam2_sd, feats[2].shape[1])
        sparse = models.embed_points(sam2_sd, pts, s)
        want_lr, want_iou = models.decode_best(
            sam2_sd, cfg["topology"]["decoder"], feats, pe, sparse)
    assert _rel(lr.float(), want_lr) < 1e-4
    assert float((iou - want_iou).abs().max()) < 1e-5


def test_prototypes_match_the_bank(tiny):
    cfg, _, dino_sd, matcher = tiny
    imgs, masks, cats = inputs.reference_set(cfg["bank"], 4,
                                             torch.device("cpu"))
    matcher.fill_memory(imgs, masks, cats)
    matcher.postprocess_memory(seed=0)
    bank = matcher.bank.feats_ins_avg.float().mean(1)
    bank = bank / bank.norm(dim=-1, keepdim=True)
    want = ref.prototypes(dino_sd, cfg["topology"]["dino"], imgs, masks,
                          cats, cfg["bank"]["classes"])
    assert _rel(bank, want) < 1e-5


@pytest.mark.parametrize("seed", [21, 22])
def test_whole_step_agrees(tiny_root, torch_threads, seed):
    """The port in float32 against the reference: every number far inside
    the tiny limits (the masks travel as float16, ~5e-4)."""
    res = run_tiny(tiny_root, "tiny.single", seed=seed)
    assert res["correct"], res["check"]
    assert res["check"]["mask_rel"]["value"] < 1e-3
    for n in ("dino_cos", "fpn_cos", "score_gap", "tail_gap",
              "finalize_err"):
        assert res["check"][n]["value"] < 1e-4, n


def test_gate_activation_is_seen(tiny_root, torch_threads):
    """A configuration file that states SiLU for the gated MLP that the
    program computes with GELU: the reference follows the file, and
    `dino_cos` reads over its limit."""
    res = run_tiny(tiny_root, "tiny_v3gated_silu.single", seed=24)
    d = res["check"]["dino_cos"]
    assert d["value"] > d["limit"], res["check"]
    assert not res["correct"]


def test_ref_block():
    """Blocks of 8 references for DINOv2-L at 518^2 (3 x 16 heads x 1370^2
    float32 logits, 360 MB an image); 5 for DINOv3-7B at 592^2 (3 x 32 x
    1374^2, 725 MB), within 4 GiB."""
    assert ref.ref_block({"img_size": 518, "patch_size": 14, "dim": 1024,
                          "heads": 16, "mlp_ratio": 4}) == 8
    assert ref.ref_block({"family": "dinov3", "img_size": 592,
                          "patch_size": 16, "dim": 4096, "heads": 32,
                          "registers": 4, "mlp_hidden": 8192}) == 5


def test_finalize_reference():
    """`upsample` is bilinear with half-pixel centres: a logit map that is
    a linear ramp stays a ramp."""
    lr = torch.arange(8.0).repeat(8, 1)[None] - 3.5
    up = ref.upsample(lr, 16, 16)[0]
    assert np.allclose(up[0, 2:-2].numpy(),
                       (np.arange(16)[2:-2] + 0.5) / 2 - 0.5 - 3.5, atol=1e-6)


def test_mask_bits_round_trip():
    """The capture's packed masks unpack to the same pixels."""
    from portbench.harness.check import pack_bits, unpack_bits
    g = torch.Generator().manual_seed(3)
    masks = torch.rand((5, 16, 24), generator=g) > 0.5
    packed = pack_bits(masks)
    assert packed.dtype == torch.uint8 and packed.shape == (5, 48)
    assert torch.equal(unpack_bits(packed, 16, 24), masks)


def test_tail_on_the_programs_decode_matches_the_step(tiny):
    """`match` on masks > 0 gives the reference step's own outputs."""
    cfg, sam2_sd, dino_sd, _ = tiny
    imgs, masks, cats = inputs.reference_set(cfg["bank"], 4,
                                             torch.device("cpu"))
    protos = ref.prototypes(dino_sd, cfg["topology"]["dino"], imgs, masks,
                            cats, cfg["bank"]["classes"])
    step = ref.Step(cfg, sam2_sd, dino_sd, protos, torch.device("cpu"))
    img = torch.rand((128, 128, 3), generator=torch.Generator().manual_seed(9))
    out = step(img)
    again = ref.match(out["dino"], out["lr"] > 0, out["iou"], protos,
                      cfg["topology"]["dino"], cfg["matching"])
    assert again["outputs"] == out["outputs"]
    assert len(out["outputs"]) > 0
