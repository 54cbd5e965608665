"""The port's SAM2ImagePredictor against the JAX package's on the CPU, in
float32, on one port init carried to the JAX tree by the JAX package's own
converter (`utils/torch_convert.convert_sam2`).

Cases: one point, three points with multimask, a batch of boxes, a box with
a mask input, the hole / sprinkle postprocess, and one 256^2 case under
attention_impl="pallas" in which the port's window kernel takes its plain
version and the JAX package's decoder kernels K2 / K3 run in the Pallas
interpreter. Tolerances: 1e-4 (absolute and relative) on the low-resolution
logits and the predicted IoUs, whose float32 sums the two frameworks take in
another order through two transformer layers and the upscale chain; the
binary masks at the original size agree wherever the logit there is
further than 1e-3 from the threshold.
"""
import dataclasses

import numpy as np
import pytest
import jax
import torch

from no_time_to_train_tpu.config.presets import Sam2Config
from no_time_to_train_tpu.models.sam2.image_predictor import (
    SAM2ImagePredictor as JPredictor)
from no_time_to_train_tpu.models.sam2.model import SAM2 as JSAM2
from no_time_to_train_tpu.utils.torch_convert import convert_sam2
from no_time_to_train_tpu_torch.models.sam2.image_predictor import (
    SAM2ImagePredictor)
from no_time_to_train_tpu_torch.models.sam2.model import SAM2
from no_time_to_train_tpu_torch.ops.attention import set_attention_impl
from no_time_to_train_tpu_torch.utils.init import init_random_

from test_torch_flash_attention import port_calls  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
# the TINY topology of tests/test_amg_predictor.py and test_matcher_amg.py
TINY = Sam2Config(
    embed_dim=32, num_heads=1, stages=(1, 1, 1, 1), global_att_blocks=(2,),
    window_pos_embed_bkg_spatial_size=(2, 2), window_spec=(4, 2, 4, 2),
    backbone_channel_list=(256, 128, 64, 32), image_size=128)
# at 256^2 stage 1 holds 64^2 tokens in 256 windows of 16, the window
# kernel's gate; no attention of the encoder reaches 512 tokens, so the JAX
# package's encoder stays on XLA when its device check is lifted
TINY_256 = dataclasses.replace(TINY, image_size=256)


def sam2_pair(cfg, seed=0):
    """(JAX SAM2, its params, the port's SAM2) on one port init whose every
    parameter is then nudged by seeded noise, so that biases and norm
    scales take part."""
    tm = SAM2(cfg)
    init_random_(tm, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = {k: (v.numpy() + 0.05 * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in tm.state_dict().items()}
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    params = jax.tree.map(np.asarray, convert_sam2(sd, cfg))
    return JSAM2(cfg), params, tm.eval()


@pytest.fixture(scope="module")
def tiny_pair():
    return sam2_pair(TINY)


@pytest.fixture(scope="module")
def predictors(tiny_pair):
    """One JAX and one port predictor for the module: the JAX package's
    programs are compiled once per shape."""
    jm, params, tm = tiny_pair
    return JPredictor(jm, params), SAM2ImagePredictor(tm)


@pytest.fixture
def jax_decoder_in_interpreter(monkeypatch):
    """The JAX package's fused decoder path with its device check lifted
    and its Pallas kernels run by the interpreter on the CPU. Yields the
    number of times each of K2 / K3 was traced."""
    from no_time_to_train_tpu.ops import decoder_attention as jda
    from no_time_to_train_tpu.ops import upscale_product as jup
    monkeypatch.setattr(jup, "default_device_is_cpu", lambda: False)
    monkeypatch.setattr(jda, "_INTERPRET", True)
    traced = {"fused_t2i_attn": 0, "fused_i2t_norm": 0}

    def counted(name):
        fn = getattr(jda, name)

        def wrapper(*a, **kw):
            traced[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name in traced:
        monkeypatch.setattr(jda, name, counted(name))
    return traced


def _assert_same(got, want, mask_threshold=0.0):
    (gm, gi, gl), (wm, wi, wl) = got, want
    assert gm.shape == wm.shape and gm.dtype == wm.dtype
    np.testing.assert_allclose(gl, wl, **TOL)
    np.testing.assert_allclose(gi, np.asarray(wi, np.float32), **TOL)
    if gm.dtype == bool:
        return
    np.testing.assert_allclose(gm, wm, **TOL)


def _predict_both(jpred, tpred, img, **kw):
    jpred.set_image(img)
    tpred.set_image(img)
    want = jpred.predict(**kw, return_logits=True)
    got = tpred.predict(**kw, return_logits=True)
    _assert_same(got, want)
    # the binary masks: equal away from the threshold
    bw, bg = jpred.predict(**kw)[0], tpred.predict(**kw)[0]
    far = np.abs(want[0] - jpred.mask_threshold) > 1e-3
    assert bg.dtype == bool and bg.shape == bw.shape
    np.testing.assert_array_equal(bg[far], bw[far])
    return got


def _prompts(rng, oh, ow):
    s = np.array([ow, oh], np.float32)
    return {
        "one point": dict(point_coords=rng.uniform(0, 1, (1, 2)) * s,
                          point_labels=[1]),
        "three points, multimask": dict(
            point_coords=rng.uniform(0, 1, (3, 2)) * s,
            point_labels=[1, 0, 1], multimask_output=True),
        "four boxes": dict(
            box=np.concatenate([rng.uniform(0, 0.4, (4, 2)) * s,
                                rng.uniform(0.6, 1, (4, 2)) * s], 1),
            multimask_output=False),
        "box and mask input": dict(
            box=[ow * 0.2, oh * 0.1, ow * 0.8, oh * 0.7],
            mask_input=4 * rng.standard_normal((32, 32)).astype(np.float32),
            multimask_output=False),
    }


@pytest.mark.parametrize("case", ["one point", "three points, multimask",
                                  "four boxes", "box and mask input"])
def test_predict_matches_jax(predictors, case):
    rng = np.random.default_rng(1)
    img = rng.random((96, 112, 3)).astype(np.float32)
    kw = _prompts(rng, 96, 112)[case]
    masks, ious, lr = _predict_both(*predictors, img, **kw)
    n_box = 4 if case == "four boxes" else 1
    m = 3 if kw.get("multimask_output", True) else 1
    assert masks.shape == (n_box, m, 96, 112)
    assert ious.shape == (n_box, m) and lr.shape == (n_box, m, 32, 32)
    assert np.isfinite(lr).all() and np.abs(lr).max() <= 32.0


def test_hole_and_sprinkle_postprocess_matches_jax(predictors):
    """max_hole_area / max_sprinkle_area above 0: the connected components
    of the low-resolution logits fill holes and remove sprinkles, as in the
    JAX package; the postprocess has to change the logits here."""
    rng = np.random.default_rng(2)
    img = rng.random((96, 112, 3)).astype(np.float32)
    kw = dict(point_coords=[[30.0, 50.0]], point_labels=[1])
    raw = _predict_both(*predictors, img, **kw)
    try:
        for pred in predictors:
            pred.max_hole_area = pred.max_sprinkle_area = 40.0
        got = _predict_both(*predictors, img, **kw)
    finally:
        for pred in predictors:
            pred.max_hole_area = pred.max_sprinkle_area = 0.0
    assert (got[2] != raw[2]).any()


def test_pallas_at_256_matches_jax_decoder_in_interpreter(
        jax_decoder_in_interpreter, port_calls):
    """attention_impl="pallas" on a 256^2 model: the port's Hiera stage 1
    takes the window kernel's plain version, the JAX decoder its Pallas K2
    and K3 in the interpreter; points and a box batch."""
    jm, params, tm = sam2_pair(TINY_256, seed=3)
    set_attention_impl(tm, "pallas")
    rng = np.random.default_rng(4)
    img = rng.random((200, 240, 3)).astype(np.float32)
    jpred, tpred = JPredictor(jm, params), SAM2ImagePredictor(tm)
    _predict_both(jpred, tpred, img, point_coords=[[120.0, 100.0]],
                  point_labels=[1])
    _predict_both(jpred, tpred, img, box=[[20.0, 30.0, 200.0, 150.0],
                                          [100.0, 50.0, 230.0, 190.0]])
    assert port_calls["window"].shapes == [(1, 4096, 96)] * 2
    # each JAX program traced K2 three times and K3 twice
    assert jax_decoder_in_interpreter == {"fused_t2i_attn": 6,
                                          "fused_i2t_norm": 4}


def test_predict_needs_an_image_and_follows_the_model(tiny_pair):
    _, _, tm = tiny_pair
    pred = SAM2ImagePredictor(tm)
    with pytest.raises(RuntimeError, match="set_image"):
        pred.predict(point_coords=[[1.0, 1.0]], point_labels=[1])
    assert pred.device == torch.device("cpu") and pred.dtype == torch.float32
