"""Port encoders vs the JAX package at tiny widths (float32, CPU): DINOv2,
and Hiera + FPN, also at sizes where the flash-attention gates open."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.config.presets import EncoderConfig, Sam2Config
from no_time_to_train_tpu.models.dino import DinoV2 as JDino
from no_time_to_train_tpu.models.sam2.model import Sam2ImageEncoder as JEnc
from no_time_to_train_tpu_torch.models.dino import DinoV2
from no_time_to_train_tpu_torch.models.sam2.neck import Sam2ImageEncoder
from no_time_to_train_tpu_torch.ops.attention import set_attention_impl
from no_time_to_train_tpu_torch.utils.convert import (
    _image_encoder, dino_state_dict)

from test_torch_flash_attention import port_calls  # noqa: F401 (fixture)


def randomize(params, seed):
    """Every leaf drawn from numpy: norm scales near 1, the rest
    normal / sqrt(fan_in), so that biases and norms are exercised."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        names = [str(getattr(k, "key", k)) for k in path]
        shape = np.shape(x)
        if names[-1] == "weight" and len(shape) == 1:
            return rng.standard_normal(shape).astype(np.float32) * 0.1 + 1
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
        return (rng.standard_normal(shape) / np.sqrt(max(fan_in, 1))
                ).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


TINY_DINO = EncoderConfig("tiny", 28, 14, 32, 2, 2, "local")
TINY_SAM = Sam2Config(
    embed_dim=32, num_heads=1, stages=(1, 2, 2, 1), global_att_blocks=(3,),
    window_pos_embed_bkg_spatial_size=(2, 2), window_spec=(4, 2, 4, 2),
    backbone_channel_list=(256, 128, 64, 32), image_size=128)


# (image size, attention_impl, kernel 9 calls): at 322 px the sequence is
# 23^2 + 1 = 530 tokens, past the 512-token gate
DINO_CASES = [pytest.param(28, "pallas", 0, id="28"),
              pytest.param(42, "pallas", 0, id="42"),
              (322, "pallas", 2), (322, "xla", 0)]


@pytest.mark.parametrize("img_size,impl,n_flash", DINO_CASES)
def test_dino_matches_jax(img_size, impl, n_flash, port_calls):
    """42 px exercises the bicubic-antialias position interpolation. Where
    the gate opens under "pallas" each layer takes kernel 9's plain version;
    the JAX package runs XLA on the CPU, so the tolerance stays."""
    jm = JDino(TINY_DINO)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, img_size, img_size, 3)).astype(np.float32)
    params = randomize(jm.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 28, 28, 3)))["params"], 1)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = DinoV2(TINY_DINO)
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in
                        dino_state_dict(params, TINY_DINO).items()})
    set_attention_impl(tm, impl)
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    assert got.shape == ref.shape
    n = (img_size // 14) ** 2 + 1
    assert port_calls["bnhd"].shapes == [(2, n, 2, 16)] * n_flash
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


# at 256^2, stage 1 holds 64^2 = 4096 tokens in 256 windows of 16 (the
# window kernel's gate) and the global block 2 of stage 2 32^2 = 1024 tokens
# (kernel 9's gate, 2 heads of 32)
SAM_256 = dataclasses.replace(TINY_SAM, stages=(1, 2, 1, 1),
                              global_att_blocks=(2,), image_size=256)


def test_hiera_fpn_matches_jax(port_calls):
    _check_hiera(TINY_SAM, "pallas")
    assert port_calls["bnhd"].shapes == port_calls["window"].shapes == []


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_hiera_fpn_flash_routes_match_jax(impl, port_calls):
    """Where the gates open under "pallas", the windowed block takes the
    window kernel's plain version on the packed qkv and the global block
    kernel 9's on strided views of it; under "xla" neither. The JAX package
    runs XLA on the CPU, so the tolerance stays."""
    _check_hiera(SAM_256, impl)
    on = impl == "pallas"
    assert port_calls["bnhd"].shapes == [(1, 1024, 2, 32)] * on
    assert port_calls["window"].shapes == [(1, 4096, 96)] * on


def _check_hiera(cfg, impl):
    s = cfg.image_size
    jm = JEnc(cfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, s, s, 3)).astype(np.float32)
    params = randomize(jm.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, s, s, 3)))["params"], 3)
    ref = jm.apply({"params": params}, jnp.asarray(x))["backbone_fpn"]
    sd = {}
    _image_encoder(sd, params)
    pre = "image_encoder."
    tm = Sam2ImageEncoder(cfg)
    tm.load_state_dict({k[len(pre):]: torch.as_tensor(v)
                        for k, v in sd.items()})
    set_attention_impl(tm, impl)
    with torch.no_grad():
        got = tm(torch.as_tensor(x))["backbone_fpn"]
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-4)


# the window_spec of SAM2-T / S / B+, (8, 4, 14, 7), on a 256^2 input: the
# stage grids are 64, 32, 16 and 8 tokens a side, so the 14-token windows
# of stage 3 pad 16 to 28 and the 7-token windows of stage 4 pad 8 to 14;
# block 4 pools 14-token windows of the padded stage-3 grid into 7-token
# ones and crops back to 8. Stage 1 (64 windows of 64 tokens) opens the
# window kernel's gate.
SAM_PADDED = Sam2Config(
    embed_dim=32, num_heads=1, stages=(1, 1, 2, 2), global_att_blocks=(),
    window_pos_embed_bkg_spatial_size=(4, 4), window_spec=(8, 4, 14, 7),
    backbone_channel_list=(256, 128, 64, 32), image_size=256)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_hiera_padded_windows_match_jax(impl, port_calls):
    """Windows that do not divide the grid pad with zeros after norm1, and
    the padded keys take part in the attention, as in the reference."""
    _check_hiera(SAM_PADDED, impl)
    assert port_calls["window"].shapes == [(1, 4096, 96)] * (impl == "pallas")
    assert port_calls["bnhd"].shapes == []


# DINOv2-giant's layout at a tiny width: the SwiGLU feed-forward, hidden
# (int(48 * 4 * 2 / 3) + 7) // 8 * 8 = 128, weights_in to 256
TINY_GIANT = EncoderConfig("tiny_giant", 28, 14, 48, 2, 2, "local",
                           ffn_layer="swiglu")


@pytest.mark.parametrize("img_size,impl,n_flash",
                         [(28, "pallas", 0), (322, "pallas", 2)])
def test_dino_swiglu_matches_jax(img_size, impl, n_flash, port_calls):
    """One port init, nudged by seeded noise, carried to the JAX tree by
    the JAX package's converter `convert_hf_dinov2`, and back by the port's
    `dino_state_dict` unchanged; then both encoders on the same images (at
    322 px kernel 9's gate opens)."""
    from no_time_to_train_tpu.models.dino import convert_hf_dinov2
    from no_time_to_train_tpu_torch.utils.init import init_random_
    tm = DinoV2(TINY_GIANT)
    assert tuple(tm.encoder.layer[0].mlp.weights_in.weight.shape) == (256, 48)
    init_random_(tm, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(4)
    sd = {k: (v.numpy() + 0.05 * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in tm.state_dict().items()}
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    params = convert_hf_dinov2(sd, TINY_GIANT)
    back = dino_state_dict(params, TINY_GIANT)
    assert set(back) == set(sd)
    for k in set(sd) - {"embeddings.mask_token"}:     # unused, written as 0
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    x = rng.standard_normal((2, img_size, img_size, 3)).astype(np.float32)
    ref = np.asarray(JDino(TINY_GIANT).apply({"params": params},
                                             jnp.asarray(x)))
    set_attention_impl(tm, impl)
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    n = (img_size // 14) ** 2 + 1
    assert port_calls["bnhd"].shapes == [(2, n, 2, 24)] * n_flash
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


# a DINOv2 without layer scale (init_values None, ROADMAP C.17) at the
# giant test's width 48, MLP feed-forward
TINY_NO_LAYER_SCALE = dataclasses.replace(TINY_GIANT, name="tiny_no_ls",
                                          ffn_layer="mlp", init_values=None)


def test_dino_without_layer_scale_matches_jax(port_calls):
    """init_values None: the port builds blocks without lambda1 (the JAX
    package's use_layer_scale=False); one port init, nudged by seeded
    noise, carried to the JAX tree by `convert_hf_dinov2` and back by
    `dino_state_dict`, then both encoders on the same images."""
    from no_time_to_train_tpu.models.dino import convert_hf_dinov2
    from no_time_to_train_tpu_torch.utils.init import init_random_
    cfg = TINY_NO_LAYER_SCALE
    tm = DinoV2(cfg)
    assert tm.encoder.layer[0].layer_scale1 is None
    init_random_(tm, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(5)
    sd = {k: (v.numpy() + 0.05 * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in tm.state_dict().items()}
    assert not any("layer_scale" in k for k in sd)
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    params = convert_hf_dinov2(sd, cfg)
    assert "layer_scale1" not in params["layer_0"]
    back = dino_state_dict(params, cfg)
    assert set(back) == set(sd)
    x = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    ref = np.asarray(JDino(cfg).apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_dinov2_giant_preset_builds():
    """The preset is no longer refused: 40 layers of SwiGLU at width 1536
    (built on the meta device, no memory)."""
    from no_time_to_train_tpu_torch.config.presets import ENCODER_PRESETS
    with torch.device("meta"):
        g = DinoV2(ENCODER_PRESETS["dinov2_giant"])
    assert len(g.encoder.layer) == 40
    assert tuple(g.encoder.layer[0].mlp.weights_in.weight.shape) == (
        2 * 4096, 1536)
