"""The port's automatic mask generator against the JAX package's on the CPU,
in float32, on one port init carried to the JAX tree by the JAX package's
own converter: the point grids and crop boxes, the candidates of one decode
(logits, predicted IoUs, stability scores, boxes, the keep flags before and
after the box NMS), and the records of `generate` on the plain grid (with
and without the NMS), with RLE output, with the small-region postprocess,
with crops and with the m2m refinement, plus one 256^2 case under
attention_impl="pallas" with the JAX package's decoder kernels in the
Pallas interpreter.

Random weights give masks that all cover most of the image, so the box NMS
at the default 0.7 keeps one; the record cases turn it off (1.0) to compare
many records, and the decode cases hold the keep flags at 0.7. The filter
thresholds sit in gaps of the port's own values (five times the tolerance
below from any for the predicted IoU, twice it for the stability score,
whose values lie one pixel apart), so that the filters drop some candidates
and keep others.

Tolerances: logits and predicted IoUs 1e-4 (absolute and relative), the
band of tests/test_torch_image_predictor.py; a stability score is a ratio
of pixel counts at logit +-1, which moves by one pixel of its union (1.2e-3
at the unions of 800 pixels and more here) where a logit lies within that
band of +-1: 2e-3. Boxes, keep flags, areas, masks and RLEs are compared
exactly.
"""
import numpy as np
import pytest
import jax.numpy as jnp

from no_time_to_train_tpu.models.sam2 import amg as jamg
from no_time_to_train_tpu_torch.data import rle as trle
from no_time_to_train_tpu_torch.models.sam2 import amg as tamg
from no_time_to_train_tpu_torch.ops.attention import set_attention_impl

from test_torch_image_predictor import (  # noqa: F401 (fixtures)
    TINY_256, jax_decoder_in_interpreter, port_calls, sam2_pair,
    tiny_pair)

TOL = dict(rtol=1e-4, atol=1e-4)
STAB_ATOL = 2e-3
BASE = dict(points_per_side=4, points_per_batch=8)


def gap_threshold(values, q, margin):
    """A threshold near the q-quantile of `values` that lies at least
    `margin` from every one of them and leaves two or more above it; 0 (the
    filter off) where there is none."""
    v = np.unique(np.asarray(values, np.float64))
    i = int(q * len(v))
    for j in sorted(range(len(v) - 2), key=lambda j: abs(j - i)):
        if v[j + 1] - v[j] >= 2 * margin:
            return float((v[j] + v[j + 1]) / 2)
    return 0.0


def thresholds(tm, img, **kw):
    """pred_iou_thresh and stability_score_thresh in gaps of the port's own
    candidates (zero thresholds)."""
    probe = tamg.SAM2AutomaticMaskGenerator(
        tm, **{**BASE, **kw}, pred_iou_thresh=0.0, stability_score_thresh=0.0)
    _, ious, stab, _, _, _ = probe._decode(img, probe.point_grids[0])
    return dict(pred_iou_thresh=gap_threshold(ious.numpy(), 0.3,
                                              5 * TOL["atol"]),
                stability_score_thresh=gap_threshold(stab.numpy(), 0.3,
                                                     2 * STAB_ATOL))


def pair(tiny_pair, **kw):
    jm, params, tm = tiny_pair
    return (jamg.SAM2AutomaticMaskGenerator(jm, params, **BASE, **kw),
            tamg.SAM2AutomaticMaskGenerator(tm, **BASE, **kw))


def _seg(rec):
    s = rec["segmentation"]
    return s if isinstance(s, np.ndarray) else s["counts"]


def assert_same_records(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("area", "bbox", "point_coords", "crop_box"):
            assert g[k] == w[k], k
        if isinstance(w["segmentation"], np.ndarray):
            np.testing.assert_array_equal(g["segmentation"],
                                          w["segmentation"])
        else:
            assert g["segmentation"] == w["segmentation"]
        np.testing.assert_allclose(g["predicted_iou"], w["predicted_iou"],
                                   **TOL)
        np.testing.assert_allclose(g["stability_score"],
                                   w["stability_score"], atol=STAB_ATOL)


def test_point_grids_and_crop_boxes_match_jax():
    for n in (1, 4, 32):
        np.testing.assert_array_equal(tamg.build_point_grid(n),
                                      jamg.build_point_grid(n))
    for got, want in zip(tamg.build_all_layer_point_grids(8, 2, 2),
                         jamg.build_all_layer_point_grids(8, 2, 2)):
        np.testing.assert_array_equal(got, want)
    for size, layers in (((480, 640), 2), ((1024, 1024), 1), ((333, 500), 3)):
        assert tamg.generate_crop_boxes(size, layers, 512 / 1500) == \
            jamg.generate_crop_boxes(size, layers, 512 / 1500)


def _img(seed, h=64, w=64):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


# (name, generator keywords): the 4 x 4 grid in chunks of 8; the single
# mask output; the m2m refinement on a 3 x 3 grid in chunks of 4 (the last
# chunk padded, its candidates invalid)
DECODE_CASES = [("grid", {}),
                ("single mask", dict(multimask_output=False)),
                ("m2m, padded chunk", dict(use_m2m=True, points_per_side=3,
                                           points_per_batch=4))]


@pytest.mark.parametrize("name,kw", DECODE_CASES,
                         ids=[c[0] for c in DECODE_CASES])
def test_decode_candidates_match_jax(tiny_pair, name, kw):
    jm, params, tm = tiny_pair
    img = _img(5)
    kw = {**BASE, **kw}
    kw.update(thresholds(tm, img, **kw))
    jgen = jamg.SAM2AutomaticMaskGenerator(jm, params, **kw)
    tgen = tamg.SAM2AutomaticMaskGenerator(tm, **kw)
    pts01 = jgen.point_grids[0]
    want = jgen._jit_decode(params, jnp.asarray(img),
                            jnp.asarray(pts01, jnp.float32),
                            n_points=len(pts01))
    masks, ious, stab, boxes, keep, final = tgen._decode(img, pts01)
    np.testing.assert_allclose(masks.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(ious.numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(stab.numpy(), np.asarray(want[2]),
                               atol=STAB_ATOL)
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(final.numpy(), np.asarray(want[4]))
    # the filters drop some candidates and keep some; the NMS keeps fewer
    assert 0 < int(final.sum()) < int(keep.sum()) < keep.numel()
    if name in ("grid", "m2m, padded chunk"):
        # and the records of `generate` on the same programs
        assert_same_records(tgen.generate(img), jgen.generate(img))


def test_generate_records_match_jax(tiny_pair):
    """The plain grid with the NMS off; the same candidates as RLEs, which
    decode to the binary masks; and after the small-region postprocess,
    which has to change some masks here."""
    img = _img(6)
    kw = dict(thresholds(tiny_pair[2], img), box_nms_thresh=1.0)
    jgen, tgen = pair(tiny_pair, **kw)
    binary = tgen.generate(img)
    assert_same_records(binary, jgen.generate(img))
    assert tgen.last_counts["into_nms"] == len(binary)
    for gen in (jgen, tgen):
        gen.output_mode = "coco_rle"
    rles = tgen.generate(img)
    assert_same_records(rles, jgen.generate(img))
    for b, r in zip(binary, rles):
        np.testing.assert_array_equal(
            trle.decode_rle(r["segmentation"]).astype(bool),
            b["segmentation"])
    for gen in (jgen, tgen):
        gen.output_mode, gen.min_mask_region_area = "binary_mask", 60
    small = tgen.generate(img)
    assert_same_records(small, jgen.generate(img))
    assert any(s["area"] != b["area"] for s, b in zip(small, binary))


def test_generate_with_crops_matches_jax(tiny_pair):
    """crop_n_layers=1: the whole image and four crops (an overlap of 16
    pixels makes each crop of the 64^2 image 40^2), then the cross-crop
    NMS, which has to drop some records here."""
    img = _img(7)
    kw = dict(thresholds(tiny_pair[2], img), crop_n_layers=1,
              crop_overlap_ratio=0.25, box_nms_thresh=1.0)
    jgen, tgen = pair(tiny_pair, **kw)
    got = tgen.generate(img)
    assert_same_records(got, jgen.generate(img))
    assert len({tuple(r["crop_box"]) for r in got}) > 1
    assert len(got) < tgen.last_counts["kept"]


def test_small_region_postprocess_matches_jax(tiny_pair):
    """The synthetic mask of tests/test_amg_predictor.py: a hole of 4
    pixels is filled, a sprinkle of 4 removed, box and area follow."""
    jgen, tgen = pair(tiny_pair, min_mask_region_area=6)
    seg = np.zeros((32, 32), bool)
    seg[4:20, 4:20] = True
    seg[8:10, 8:10] = False
    seg[28:30, 28:30] = True
    rec = {"segmentation": seg, "area": int(seg.sum()), "bbox": [4, 4, 25, 25],
           "predicted_iou": 0.9, "point_coords": [[0, 0]],
           "stability_score": 1.0, "crop_box": [0, 0, 32, 32]}
    empty = dict(rec, segmentation=np.zeros((32, 32), bool))
    got = tgen.postprocess_small_regions([rec, empty])
    want = jgen.postprocess_small_regions([rec, empty])
    assert_same_records(got, want)
    out = got[0]["segmentation"]
    assert len(got) == 1 and out[8, 8] and not out[28, 28]
    assert got[0]["bbox"] == [4, 4, 15, 15] and got[0]["area"] == 256


def test_generate_pallas_at_256_matches_jax_decoder_in_interpreter(
        jax_decoder_in_interpreter, port_calls):
    jm, params, tm = sam2_pair(TINY_256, seed=3)
    set_attention_impl(tm, "pallas")
    img = _img(8, 200, 240)
    kw = dict(thresholds(tm, img), box_nms_thresh=1.0)
    jgen = jamg.SAM2AutomaticMaskGenerator(jm, params, **BASE, **kw)
    tgen = tamg.SAM2AutomaticMaskGenerator(tm, **BASE, **kw)
    port_calls["window"].shapes.clear()
    assert_same_records(tgen.generate(img), jgen.generate(img))
    assert port_calls["window"].shapes == [(1, 4096, 96)]
    assert jax_decoder_in_interpreter["fused_i2t_norm"] > 0


def test_output_mode_is_checked(tiny_pair):
    with pytest.raises(ValueError, match="output_mode"):
        tamg.SAM2AutomaticMaskGenerator(tiny_pair[2], output_mode="polygon")
