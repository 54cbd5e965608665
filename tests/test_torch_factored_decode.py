"""The port's rank-factored grid decoder (`models/sam2/factored_decode.py`,
`decoder_impl="factored"`) against the JAX package's and against the port's
dense decoder (float32, CPU)."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.models.sam2.factored_decode import (
    factored_best_of_multimask as j_factored)
from no_time_to_train_tpu.models.sam2.mask_decoder import (
    MaskDecoder as JMaskDecoder)
from no_time_to_train_tpu_torch.models.sam2.factored_decode import (
    factored_best_of_multimask)
from no_time_to_train_tpu_torch.models.sam2 import mask_decoder as tmd
from no_time_to_train_tpu_torch.models.sam2 import transformer as ttr
from no_time_to_train_tpu_torch.models.sam2.mask_decoder import MaskDecoder
from no_time_to_train_tpu_torch.utils.convert import _mask_decoder

from test_torch_matching import _assert_same_outputs, _pair

# tests/test_factored_decode.py's bands for the factored form against the
# dense decoder in float32 (the same sums re-associated): IoUs 2e-4, mask
# logits 2e-3; the port against the JAX package's factored form computes
# the same association, read at under 1e-5 on this CPU
IOU_TOL, MASK_TOL, SAME_FORM_TOL = 2e-4, 2e-3, 1e-4


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape, np.float32) * scale).astype(np.float32)


def _decoders(pred_obj_scores, use_hr, sigmoid):
    """The JAX decoder's noisy params (the JAX test's draw) and the port's
    MaskDecoder holding them, with the test's inputs."""
    rng = np.random.default_rng(0)
    c, h, w, p, ts = 64, 8, 8, 5, 2
    kw = dict(use_high_res_features=use_hr, pred_obj_scores=pred_obj_scores,
              pred_obj_scores_mlp=pred_obj_scores,
              iou_prediction_use_sigmoid=sigmoid, transformer_num_heads=4,
              transformer_mlp_dim=128)
    jdec = JMaskDecoder(transformer_dim=c, **kw)
    img = _randn(rng, 1, h, w, c, scale=0.5)
    pe = _randn(rng, h, w, c, scale=0.5)
    sparse = _randn(rng, p, ts, c, scale=0.5)
    dense1 = _randn(rng, 1, h, w, c, scale=0.5)
    hr = ([_randn(rng, 1, 4 * h, 4 * w, c // 8, scale=0.5),
           _randn(rng, 1, 2 * h, 2 * w, c // 4, scale=0.5)]
          if use_hr else None)
    variables = jdec.init(jax.random.PRNGKey(0), jnp.asarray(img),
                          jnp.asarray(pe), jnp.asarray(sparse),
                          jnp.asarray(dense1), repeat_image=False,
                          high_res_features=None if hr is None else
                          [jnp.asarray(a) for a in hr],
                          multimask_output=True)
    leaves, treedef = jax.tree.flatten(variables["params"])
    params = jax.tree.unflatten(treedef, [
        _randn(rng, *np.shape(l), scale=0.3) + (1.0 if np.ndim(l) == 1
                                                 else 0.0) for l in leaves])
    sd = {}
    _mask_decoder(sd, params)
    tdec = MaskDecoder(c, **kw)
    prefix = "sam_mask_decoder."
    missing, unexpected = tdec.load_state_dict(
        {k[len(prefix):]: torch.as_tensor(v) for k, v in sd.items()},
        strict=False)
    # the 1x1 high-resolution convs run in forward_image, not here
    assert not unexpected and all(k.startswith("conv_s") for k in missing)
    inputs = (img, pe, sparse, dense1, hr)
    return jdec, params, tdec.eval(), inputs


def _no_call(*args, **kwargs):
    raise AssertionError("the factored form called a decoder kernel entry")


CASES = [(True, True, True), (False, False, False), (True, False, True),
         (False, True, False)]


@pytest.mark.parametrize("pred_obj_scores,use_hr,sigmoid", CASES)
def test_factored_matches_jax_and_dense(pred_obj_scores, use_hr, sigmoid,
                                        monkeypatch):
    """The port's factored form against the JAX package's on the same
    weights, and against the port's dense decoder at the JAX test's bands;
    the factored form calls none of the decoder kernels' entries."""
    jdec, params, tdec, (img, pe, sparse, dense1, hr) = _decoders(
        pred_obj_scores, use_hr, sigmoid)
    mask_j, iou_j = j_factored(
        params, jnp.asarray(img), jnp.asarray(pe), jnp.asarray(sparse),
        jnp.asarray(dense1), None if hr is None else
        [jnp.asarray(a) for a in hr], num_heads=4,
        pred_obj_scores=pred_obj_scores, iou_use_sigmoid=sigmoid)
    t = [torch.as_tensor(a) for a in (img, pe, sparse, dense1)]
    t_hr = None if hr is None else [torch.as_tensor(a) for a in hr]
    with torch.no_grad():
        mask_d, iou_d = tdec.predict_best_of_multimask(*t, high_res_features=
                                                       t_hr)
        for mod, name in ((ttr, "fused_t2i_attn"), (ttr, "fused_i2t_norm"),
                          (ttr, "fused_i2t_norm_pair"),
                          (tmd, "fused_post_t1")):
            monkeypatch.setattr(mod, name, _no_call)
        mask_f, iou_f = factored_best_of_multimask(tdec, *t, t_hr)
    assert mask_f.shape == mask_d.shape == (5, 32, 32)
    np.testing.assert_allclose(iou_f.numpy(), np.asarray(iou_j),
                               rtol=SAME_FORM_TOL, atol=SAME_FORM_TOL)
    np.testing.assert_allclose(mask_f.numpy(), np.asarray(mask_j),
                               rtol=SAME_FORM_TOL, atol=SAME_FORM_TOL)
    np.testing.assert_allclose(iou_f.numpy(), iou_d.numpy(), rtol=IOU_TOL,
                               atol=IOU_TOL)
    np.testing.assert_allclose(mask_f.numpy(), mask_d.numpy(), rtol=MASK_TOL,
                               atol=MASK_TOL)


def test_pipeline_factored_branch_matches_jax():
    """tests/test_factored_decode.py's pipeline case: `_decode_grid` with
    decoder_impl="factored", port against JAX on the same weights, and
    against the port's dense branch at the JAX test's bands."""
    jm, tm = _pair(decoder_impl="factored")
    img = np.random.default_rng(0).random((128, 128, 3), np.float32)
    lr_j, iou_j, _ = jm._decode_grid(jm.sam2_params, jnp.asarray(img))
    with torch.no_grad():
        lr_f, iou_f, _ = tm._decode_grid(torch.as_tensor(img))
        tm.matching = dataclasses.replace(tm.matching, decoder_impl="dense")
        lr_d, iou_d, _ = tm._decode_grid(torch.as_tensor(img))
    np.testing.assert_allclose(iou_f.numpy(), np.asarray(iou_j), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(lr_f.numpy(), np.asarray(lr_j, np.float32),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(iou_f.numpy(), iou_d.numpy(), rtol=IOU_TOL,
                               atol=IOU_TOL)
    np.testing.assert_allclose(lr_f.numpy(), lr_d.numpy(), rtol=MASK_TOL,
                               atol=MASK_TOL)


def test_factored_step_matches_jax():
    """The whole tiny step under decoder_impl="factored", port against JAX
    (the tolerances of tests/test_torch_matching.py)."""
    jm, tm = _pair(decoder_impl="factored")
    img = np.random.default_rng(5).random((128, 128, 3), np.float32)
    _assert_same_outputs(jm.test(img), tm.test(img))


def test_factored_batch_equals_images_alone():
    """A batch of two: each image's chunk decodes on its own factored form,
    so given the same features a batch equals its images alone bit for bit;
    `test_batch_async` against `test` on each image within the float32
    bands (the encoders at batch 2 sum in another order on the CPU)."""
    _, tm = _pair(decoder_impl="factored")
    imgs = np.random.default_rng(21).random((2, 128, 128, 3), np.float32)
    x = tm._normalize(torch.as_tensor(imgs)).to(tm.dtype)
    with torch.no_grad():
        fpn = tm.sam2.forward_image(x)["backbone_fpn"]
        feats, hr = fpn[-1], [fpn[0], fpn[1]]
        pts = torch.tensor([[[20.5, 30.5]], [[90.5, 70.5]], [[64.5, 64.5]]])
        labels = torch.ones((3, 1), dtype=torch.long)
        lr2, iou2 = tm._decode_chunk_factored(feats, pts, labels, hr)
        for b in range(2):
            lr1, iou1 = tm._decode_chunk_factored(
                feats[b:b + 1], pts, labels, [f[b:b + 1] for f in hr])
            assert torch.equal(lr2[3 * b:3 * b + 3], lr1)
            assert torch.equal(iou2[3 * b:3 * b + 3], iou1)
    out = tm.fetch_test(tm.test_batch_async(imgs))
    for b in range(2):
        _assert_same_outputs(tm.test(imgs[b]), {k: v[b] for k, v in
                                                out.items()})


def test_matching_config_refuses_unknown_options():
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        MatchingConfig)
    assert MatchingConfig().decoder_impl == "dense"
    assert MatchingConfig().encoder_quant == "none"
    with pytest.raises(ValueError, match="decoder_impl"):
        MatchingConfig(decoder_impl="bogus")
    with pytest.raises(ValueError, match="encoder_quant"):
        MatchingConfig(encoder_quant="int4")

