"""The port's Matcher-AMG against the JAX package's on the CPU, in float32,
on one port init carried to the JAX tree by the JAX package's own
converter: the six behaviours of tests/test_matcher_amg.py (select points,
select with a shared box, the box as corner points equal to the prompt
encoder's box path, dense_pred, extra_mask_data in the NMS, the refused
mask input), each against the JAX generator on the same inputs.

Tolerances: predicted IoUs and the boxes of dense_pred 1e-4 (absolute and
relative; the boxes are mask boxes in whole pixels, scaled), stability
scores 2e-3 (one pixel of a union of 800 or more moves one by 1.2e-3, as in
tests/test_torch_amg.py);
the sparse embeddings of the box paths 1e-6, as the JAX test; the masks at
the original size are compared exactly.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.models.matching.matcher_amg import (
    SAM2AutomaticMaskGeneratorMatcher as JMatcherAMG)
from no_time_to_train_tpu_torch.models.matching.matcher_amg import (
    SAM2AutomaticMaskGeneratorMatcher)

from test_torch_image_predictor import tiny_pair  # noqa: F401 (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0,
          stability_score_thresh=0.0)


@pytest.fixture(scope="module")
def gens(tiny_pair):
    jm, params, tm = tiny_pair
    return JMatcherAMG(jm, params, **KW), SAM2AutomaticMaskGeneratorMatcher(
        tm, **KW)


def _both(gens, img, **kw):
    jgen, tgen = gens
    (jm_, ji), (tm_, ti) = jgen.generate(img, **kw), tgen.generate(img, **kw)
    assert tm_.dtype == bool and tm_.shape == jm_.shape
    np.testing.assert_array_equal(tm_, jm_)
    np.testing.assert_allclose(ti, ji, **TOL)
    return tm_, ti


def _img(seed, h, w):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


# five point prompts on a 64^2 image: the select tests share the JAX
# package's compiled programs
def test_select_points_match_jax(gens):
    """Five prompts from two lists, each point its own prompt."""
    masks, ious = _both(
        gens, _img(1, 64, 64),
        select_point_coords=[np.array([[20.0, 30.0], [60.0, 10.0]]),
                             np.array([[40.0, 40.0], [5.0, 60.0],
                                       [30.0, 12.0]])],
        select_point_labels=[np.array([1, 1]), np.array([1, 0, 1])])
    assert masks.ndim == 3 and masks.shape[1:] == (64, 64)
    assert len(ious) == len(masks) > 0


def test_select_points_with_box_match_jax(gens):
    """Five points sharing one box; the box changes the result."""
    img = _img(2, 64, 64)
    pts = [np.array([[32.0, 32.0], [10.0, 50.0], [50.0, 12.0], [20.0, 20.0],
                     [44.0, 40.0]])]
    labels = [np.array([1, 1, 0, 1, 1])]
    masks, ious = _both(gens, img, select_point_coords=pts,
                        select_point_labels=labels,
                        select_box=[np.array([8.0, 8.0, 56.0, 56.0])])
    plain, plain_ious = _both(gens, img, select_point_coords=pts,
                              select_point_labels=labels)
    assert len(ious) == len(masks) > 0
    assert (len(ious) != len(plain_ious)
            or not np.allclose(ious, plain_ious, atol=1e-3))


def test_box_equals_prompt_encoder_box_path(gens):
    """The box as corner points with labels 2 / 3 and no padding point
    gives the sparse embedding of the prompt encoder's `boxes` argument, in
    the port as in the JAX package, and both packages agree."""
    jgen, tgen = gens
    box = np.asarray([[10.0, 12.0, 50.0, 60.0]], np.float32)
    jm, params = jgen.model, jgen.params
    want = np.asarray(jm.apply(
        {"params": params}, boxes=jnp.asarray(box),
        method=lambda m, boxes: m.sam_prompt_encoder(boxes=boxes))[0])
    pe = tgen.model.sam_prompt_encoder
    with torch.no_grad():
        by_box = pe(boxes=torch.as_tensor(box))[0].numpy()
        by_points = pe.embed_points(torch.as_tensor(box.reshape(1, 2, 2)),
                                    torch.tensor([[2, 3]]), pad=False).numpy()
    np.testing.assert_allclose(by_points, by_box, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(by_box, want, rtol=1e-6, atol=1e-6)


def test_dense_pred_matches_jax(gens):
    """The 4 x 4 grid, 3 masks a point, thresholds at 0 and no NMS: all 48
    candidates come back, in the JAX package's order."""
    jgen, tgen = gens
    img = _img(3, 64, 64)
    want, got = jgen.generate(img, dense_pred=True), \
        tgen.generate(img, dense_pred=True)
    assert set(got) == set(want) >= {"masks", "iou_preds", "stability_score",
                                     "boxes", "points"}
    assert len(got["iou_preds"]) == 16 * 3
    assert got["masks"].shape == (48, 64, 64) and got["masks"].dtype == bool
    np.testing.assert_array_equal(got["masks"], want["masks"])
    np.testing.assert_array_equal(got["points"], want["points"])
    for k in ("iou_preds", "boxes"):
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    np.testing.assert_allclose(got["stability_score"],
                               want["stability_score"], atol=2e-3)


def test_extra_mask_data_competes_in_nms_as_jax(gens):
    """An earlier candidate over the whole image with an unbeatable score
    survives the NMS and suppresses the new candidates it overlaps."""
    img = _img(4, 64, 64)
    sel = dict(select_point_coords=[np.array(
        [[32.0, 32.0], [10.0, 50.0], [50.0, 12.0], [20.0, 20.0],
         [44.0, 40.0]])], select_point_labels=[np.array([1, 1, 1, 1, 1])])
    base_masks, _ = _both(gens, img, **sel)
    extra = {"masks": np.ones((1, 64, 64), bool),
             "iou_preds": np.array([10.0], np.float32),
             "boxes": np.array([[0.0, 0.0, 64.0, 64.0]], np.float32)}
    masks, ious = _both(gens, img, **sel, extra_mask_data=extra)
    assert 10.0 in list(ious)
    assert len(masks) <= len(base_masks) + 1


def test_select_mask_input_is_not_implemented(gens):
    img = _img(5, 32, 32)
    for gen in gens:
        with pytest.raises(NotImplementedError):
            gen.generate(img, select_point_coords=[np.zeros((1, 2))],
                         select_point_labels=[np.ones(1)],
                         select_mask_input=[np.zeros((1, 32, 32))])
