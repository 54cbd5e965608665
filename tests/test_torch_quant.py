"""The port's W8A8 int8 layers (`ops/quant.py`, `encoder_quant="int8"`)
against the JAX package's `int8_dot` / `Int8Dense` (CPU, numpy seeds): the
op bit for bit, the layer's state_dict and float32 master weights, the
cache of quantized weights, the tiny towers and the tiny matcher."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn as nn

from no_time_to_train_tpu.config.presets import EncoderConfig
from no_time_to_train_tpu.models.dino import DinoV2 as JDinoV2
from no_time_to_train_tpu.models.dino_v3 import DinoV3 as JDinoV3
from no_time_to_train_tpu.models.sam2.hiera import Hiera as JHiera
from no_time_to_train_tpu.ops.quant import Int8Dense, _absmax_scale, int8_dot
from no_time_to_train_tpu_torch.models.dino import DinoV2
from no_time_to_train_tpu_torch.models.dino_v3 import DinoV3
from no_time_to_train_tpu_torch.models.sam2.hiera import Hiera
from no_time_to_train_tpu_torch.ops import quant as tq
from no_time_to_train_tpu_torch.utils.convert import (
    _image_encoder, dino_state_dict, dino_v3_state_dict)

from test_torch_encoders import randomize
from test_torch_matching import SAM, _pair

# the JAX test's shape (64, 256, 128), Hiera-L stage-1 qkv's K of 144 (not
# a multiple of 32), and a DINO-like width at a ragged row count
OP_SHAPES = [(64, 256, 128), (300, 144, 432), (137, 1024, 384)]


def _operands(m, c, f, seed, zeros=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, c)).astype(np.float32)
    kernel = (rng.normal(size=(c, f)) / 16).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    if zeros:                     # a zero row and a zero output channel
        x[3] = 0.0
        kernel[:, 7] = 0.0
    return x, kernel, bias


@pytest.mark.parametrize("m,c,f", OP_SHAPES)
def test_int8_linear_plain_equals_jax_int8_dot(m, c, f):
    """Bit for bit, with and without bias, and the dispatching entry on the
    CPU equals the plain version; the zero row and channel give zeros."""
    x, kernel, bias = _operands(m, c, f, seed=m)
    ref = np.asarray(int8_dot(jnp.asarray(x), jnp.asarray(kernel)))
    w = torch.as_tensor(np.ascontiguousarray(kernel.T))
    got = tq.int8_linear_plain(torch.as_tensor(x), w, None, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not got[3].any() and not got[:, 7].any()
    dense = Int8Dense(f)
    ref_b = np.asarray(dense.apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))
    got_b = tq.int8_linear(torch.as_tensor(x), w, torch.as_tensor(bias))
    np.testing.assert_array_equal(got_b.numpy(), ref_b)
    np.testing.assert_array_equal(
        got_b.numpy(), tq.int8_linear_plain(torch.as_tensor(x), w,
                                            torch.as_tensor(bias)).numpy())


def test_int8_linear_state_dict_and_float32_masters():
    """Int8Linear's state_dict has nn.Linear's keys, shapes and init; a
    module cast to bf16 rounds nn.Linear's weights but leaves Int8Linear's
    float32 (moved, never rounded), and the cast drops the quantized
    weight."""
    torch.manual_seed(0)
    ref = nn.Linear(48, 20)
    torch.manual_seed(0)
    lin = tq.Int8Linear(48, 20)
    sd_ref, sd = ref.state_dict(), lin.state_dict()
    assert list(sd) == list(sd_ref) == ["weight", "bias"]
    for k in sd:
        assert sd[k].shape == sd_ref[k].shape and torch.equal(sd[k], sd_ref[k])
    lin.quantized_weight()
    tower = nn.Sequential(ref, tq.Int8Linear(20, 8)).to(torch.bfloat16)
    assert tower[0].weight.dtype == torch.bfloat16
    assert tower[1].weight.dtype == tower[1].bias.dtype == torch.float32
    w32 = lin.weight.detach().clone()
    lin.to(torch.bfloat16)
    assert torch.equal(lin.weight, w32) and lin._quantized == {}


def test_bf16_layer_quantizes_float32_params_as_jax():
    """In bf16 mode the JAX package keeps float32 params and quantizes the
    float32 kernel: the port's levels and scales equal JAX's kq / ks bit for
    bit after the tower's cast to bf16, and so does the bf16 output."""
    c, f = 144, 96
    x, kernel, bias = _operands(40, c, f, seed=7, zeros=False)
    kf = jnp.asarray(kernel)
    ks = _absmax_scale(kf, axis=0)
    kq = np.asarray(jnp.clip(jnp.round(kf / ks), -127, 127).astype(jnp.int8))
    lin = tq.Int8Linear(c, f)
    lin.load_state_dict({"weight": torch.as_tensor(kernel.T.copy()),
                         "bias": torch.as_tensor(bias)})
    lin = nn.Sequential(lin).to(torch.bfloat16)[0]
    wq, ws = lin.quantized_weight()
    assert wq.shape == (f, tq.padded_width(c)) and not wq[:, c:].any()
    np.testing.assert_array_equal(wq[:, :c].numpy(), kq.T)
    np.testing.assert_array_equal(ws.numpy(), np.asarray(ks)[0])
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = Int8Dense(f, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": kernel, "bias": bias}}, xb)
    with torch.no_grad():
        got = lin(torch.as_tensor(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_quantized_weight_follows_every_write():
    """The cached levels are quantized again after load_state_dict, an
    in-place write and a new tensor put in the weight's place, and a call
    reads the current weight each time."""
    rng = np.random.default_rng(3)
    lin = tq.Int8Linear(32, 16)
    x = torch.as_tensor(rng.normal(size=(5, 32)).astype(np.float32))

    def check():
        with torch.no_grad():
            got = lin(x)
        want = tq.int8_linear_plain(x, lin.weight.detach(),
                                    lin.bias.detach())
        assert torch.equal(got, want)
        return lin.quantized_weight()

    first = check()
    assert lin.quantized_weight() is first         # no write: the cache
    w2 = torch.as_tensor(rng.normal(size=(16, 32)).astype(np.float32))
    lin.load_state_dict({"weight": w2, "bias": lin.bias.detach().clone()})
    second = check()
    assert second is not first and not torch.equal(second[1], first[1])
    with torch.no_grad():
        lin.weight.mul_(3.0)
    third = check()
    assert torch.allclose(third[1], second[1] * 3.0)
    lin.weight.data = torch.as_tensor(
        rng.normal(size=(16, 32)).astype(np.float32))
    fourth = check()
    assert not torch.equal(fourth[1], third[1])


def test_linear_cls():
    assert tq.linear_cls("none") is nn.Linear
    assert tq.linear_cls(None) is nn.Linear
    assert tq.linear_cls("int8") is tq.Int8Linear
    with pytest.raises(ValueError, match="int4"):
        tq.linear_cls("int4")


# the towers of tests/test_quant.py (DINOv2 and Hiera), a DINOv3 with
# registers and the gated MLP, and a Hiera whose blocks 0, 1, 5 and 6 run on
# the JAX package's window-major stage flow (their attention unquantized
# there, and so in the port)
DINO2 = EncoderConfig("tiny", 56, 14, 64, 2, 2, "none", init_values=1e-5)
DINO3 = EncoderConfig("tiny_v3", 32, 4, 32, 2, 2, "local",
                      num_register_tokens=4, family="dinov3")
HIERA_QUANT = dict(embed_dim=32, num_heads=1, stages=(1, 1, 2, 1),
                   window_spec=(4, 2, 2, 2), global_att_blocks=(3,))
HIERA_FLOW = dict(embed_dim=32, num_heads=1, stages=(2, 2, 3, 1),
                  window_spec=(4, 2, 2, 2), global_att_blocks=(6,))
TOWERS = ["dinov2", "dinov3", "hiera", "hiera_stage_flow"]
# port against JAX on the same weights, float32, in the form of
# tests/test_quant.py:82-108's bounds: the two compute the same levels
# except where a float32 sum taken in another order moves an activation
# across a rounding tie, which moves one level by ~0.01 in one row. The
# Hiera towers run at 32^2 (64 stage-1 tokens): at 64^2 such a flip turns up
# in one seed of three and the global blocks then spread it over every
# token, at a relative L2 (up to 0.013) that a wrong choice of quantized
# layers also gives. Read on this CPU: every element equal in the Hiera
# towers, max |d| 6e-6 and relative L2 6e-7 in the DINO towers (no element
# off by more than 1e-4). A wrong choice of quantized Hiera layers reads
# max |d| >= 0.05, share >= 0.99, relative L2 >= 0.008 on some output
# (`test_hiera_wrong_quant_choice_reads_outside_the_bands`).
TOWER_MAX_ABS = 0.05
TOWER_SHARE_OFF = 0.02
TOWER_REL_L2 = 1e-3


def _tower(name, quant):
    """(JAX module, port module, input shape) of one tiny tower."""
    if name == "dinov2":
        return (JDinoV2(DINO2, quant=quant), DinoV2(DINO2, quant=quant),
                (1, 56, 56, 3))
    if name == "dinov3":
        return (JDinoV3(DINO3, use_gated_mlp=True, quant=quant),
                DinoV3(DINO3, use_gated_mlp=True, quant=quant),
                (2, 32, 32, 3))
    kw = HIERA_QUANT if name == "hiera" else HIERA_FLOW
    return JHiera(**kw, quant=quant), Hiera(**kw, quant=quant), (1, 32, 32, 3)


def _state_dict(name, params):
    if name == "dinov2":
        return dino_state_dict(params, DINO2)
    if name == "dinov3":
        return dino_v3_state_dict(params, DINO3)
    sd = {}
    _image_encoder(sd, {"trunk": params, "neck": {}})
    return {k[len("image_encoder.trunk."):]: v for k, v in sd.items()}


def _tower_outputs(name, quant="int8"):
    """JAX int8 outputs and the port's `quant` outputs on one weight set,
    as float64 vectors."""
    jm, tm, shape = _tower(name, quant)
    jm = _tower(name, "int8")[0]
    x = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
                       ["params"], 2)
    refs = jax.tree.leaves(jm.apply({"params": params}, jnp.asarray(x)))
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in
                        _state_dict(name, params).items()})
    with torch.no_grad():
        out = tm(torch.as_tensor(x))
    outs = out if isinstance(out, list) else [out]
    assert len(outs) == len(refs)
    return ([np.asarray(t, np.float64).ravel() for t in outs],
            [np.asarray(t, np.float64).ravel() for t in refs])


def _within_bands(got, ref):
    d = np.abs(got - ref)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    return (d.max() < TOWER_MAX_ABS and (d > 1e-4).mean() < TOWER_SHARE_OFF
            and rel < TOWER_REL_L2), (d.max(), (d > 1e-4).mean(), rel)


@pytest.mark.parametrize("name", TOWERS)
def test_quantized_tower_matches_jax(name):
    gots, refs = _tower_outputs(name)
    plains, _ = _tower_outputs(name, "none")
    for got, ref, plain in zip(gots, refs, plains):
        ok, read = _within_bands(got, ref)
        assert ok, read
        # and close to the unquantized tower (tests/test_quant.py's band)
        cos = got @ plain / (np.linalg.norm(got) * np.linalg.norm(plain))
        assert cos > 0.98, cos


@pytest.mark.parametrize("flow", ["every block", "no block"])
def test_hiera_wrong_quant_choice_reads_outside_the_bands(flow, monkeypatch):
    """The control of the bands above: HIERA_FLOW with its attention
    quantized in every block, or in none, against the JAX package reads
    outside them on some output."""
    monkeypatch.setattr(
        Hiera, "stage_flow_blocks",
        lambda self, h, w: set() if flow == "every block"
        else set(range(len(self.blocks))))
    gots, refs = _tower_outputs("hiera_stage_flow")
    assert not all(_within_bands(g, r)[0] for g, r in zip(gots, refs))


def test_hiera_stage_flow_blocks_follow_the_jax_loop():
    """The blocks whose attention stays unquantized: the JAX stage flow's
    runs of more than one block (HIERA_FLOW at 64^2: blocks 0-1 of stage 1
    and 5-6 of stage 3, the global block 6 inside the run); none in
    HIERA_QUANT, whose stages hold one block each or start at a q-pool
    block."""
    assert Hiera(**HIERA_FLOW, quant="int8").stage_flow_blocks(16, 16) == {
        0, 1, 5, 6}
    assert Hiera(**HIERA_FLOW, quant="int8").stage_flow_blocks(8, 8) == {
        0, 1, 5, 6}
    assert Hiera(**HIERA_QUANT, quant="int8").stage_flow_blocks(16, 16) \
        == set()
    # a grid the window does not divide keeps every block spatial
    assert Hiera(**HIERA_FLOW, quant="int8").stage_flow_blocks(18, 18) == {
        5, 6}


# the tiny matcher with encoder_quant="int8", port against JAX on one
# weight set: a tie flip in Hiera (above) is carried by its global block to
# every token and moves the decoded logits by up to 0.1 and the predicted
# IoUs by up to 1.3e-3 (read over five 64^2 targets); at the 128^2 of
# `_pair`'s topology one target in three flipped an NMS decision. So the
# step runs at 64^2, where valid flags and labels agreed on all five, and
# holds scores, IoUs and logit signs to bands of twice those readings. The
# DINO side is held tighter by `_pair` itself: the int8 bank within 1e-4.
INT8_SCORE_ATOL = 7e-3
INT8_IOU_ATOL = 3e-3
INT8_SIGN_AGREE = 0.98


@pytest.mark.parametrize("seed", [5, 6])
def test_int8_matcher_matches_jax(seed):
    sam = dataclasses.replace(SAM, image_size=64)
    jm, tm = _pair(sam=sam, encoder_quant="int8", analysis_res=64)
    assert isinstance(tm.dino.encoder.layer[0].attention.attention.query,
                      tq.Int8Linear)
    assert isinstance(tm.sam2.image_encoder.trunk.blocks[0].attn.qkv,
                      tq.Int8Linear)
    img = np.random.default_rng(seed).random((64, 64, 3), np.float32)
    oj, ot = jm.test(img), tm.test(img)
    for k in oj:
        assert ot[k].shape == oj[k].shape, k
    np.testing.assert_array_equal(ot["valid"], oj["valid"])
    v = oj["valid"]
    np.testing.assert_array_equal(ot["labels"][v], oj["labels"][v])
    np.testing.assert_allclose(ot["scores"], oj["scores"], rtol=0,
                               atol=INT8_SCORE_ATOL)
    np.testing.assert_allclose(ot["pred_ious"][v], oj["pred_ious"][v],
                               rtol=0, atol=INT8_IOU_ATOL)
    agree = ((ot["lr_logits"][v] > 0) == (oj["lr_logits"][v] > 0)).mean()
    assert agree >= INT8_SIGN_AGREE, agree
    assert np.isfinite(ot["scores"]).all()


def test_int8_matcher_at_the_jax_tests_configuration():
    """tests/test_quant.py:111-127 on the port: Hiera-T at 256^2 and a tiny
    DINO with encoder_quant="int8" build and run the test step; scores
    finite."""
    from no_time_to_train_tpu_torch.config.presets import SAM2_PRESETS
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        MatchingConfig, NoAMGMatcher)
    sam_cfg = dataclasses.replace(SAM2_PRESETS["sam2_hiera_t.yaml"],
                                  image_size=256)
    enc_cfg = EncoderConfig("tiny", 56, 14, 32, 2, 2, "local")
    m = NoAMGMatcher(sam_cfg, enc_cfg, MatchingConfig(
        points_per_side=8, testing_point_bs=16, num_out_instance=10,
        encoder_quant="int8"), n_classes=3, memory_length=2, device="cpu")
    m.postprocess_memory()
    img = np.random.default_rng(0).random((256, 256, 3), np.float32)
    out = m.test(img)
    assert np.isfinite(out["scores"]).all()
