"""Port vs JAX package: resize, mask boxes, NMS (float32, CPU)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.ops import masks as jmasks
from no_time_to_train_tpu.ops import nms as jnms
from no_time_to_train_tpu.ops.resize import (
    _resize_matrix_np as j_resize_matrix_np, resize as j_resize,
    resize_hw as j_resize_hw)
from no_time_to_train_tpu_torch.ops import masks as tmasks
from no_time_to_train_tpu_torch.ops import nms as tnms
from no_time_to_train_tpu_torch.ops import resize as tresize


@pytest.mark.parametrize("mode,antialias,in_hw,out_hw", [
    ("bicubic", False, (37, 37), (64, 48)),
    ("bicubic", False, (64, 64), (28, 28)),
    ("bilinear", True, (37, 37), (16, 16)),
    ("bilinear", False, (16, 16), (40, 24)),
    ("nearest", False, (50, 50), (14, 14)),
])
def test_resize_matches_jax(mode, antialias, in_hw, out_hw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2,) + in_hw + (3,)).astype(np.float32)
    ref = np.asarray(j_resize(jnp.asarray(x), out_hw, mode=mode,
                                    antialias=antialias))
    got = tresize.resize(torch.as_tensor(x), out_hw, mode=mode,
                         antialias=antialias).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_resize_hw_and_matrix():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 20, 30)).astype(np.float32)
    ref = np.asarray(j_resize_hw(jnp.asarray(x), (40, 15),
                                       mode="bilinear", antialias=True))
    got = tresize.resize_hw(torch.as_tensor(x), (40, 15), mode="bilinear",
                            antialias=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tresize._resize_matrix_np(256, 480, "bilinear", False),
        j_resize_matrix_np(256, 480, "bilinear", False))


def test_batched_mask_to_box_matches_jax():
    rng = np.random.default_rng(2)
    m = np.zeros((6, 24, 32), bool)
    for i in range(5):
        y0, x0 = rng.integers(0, 12, 2)
        m[i, y0:y0 + rng.integers(1, 12), x0:x0 + rng.integers(1, 20)] = True
    # mask 5 stays empty -> [0, 0, 0, 0]
    ref = np.asarray(jmasks.batched_mask_to_box(jnp.asarray(m)))
    got = tmasks.batched_mask_to_box(torch.as_tensor(m)).numpy()
    np.testing.assert_array_equal(got, ref)


def _nms_case(seed, n, n_cls):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 50, (n, 2))
    wh = rng.uniform(2, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    # a few exact duplicates and equal scores exercise the tie order
    boxes[1] = boxes[0]
    scores = rng.random(n).astype(np.float32)
    scores[3] = scores[2]
    classes = rng.integers(0, n_cls, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    return boxes, scores, classes, valid


@pytest.mark.parametrize("seed,n,n_cls,thr", [(0, 40, 3, 0.5), (1, 150, 2, 0.3),
                                             (2, 70, 1, 0.0)])
def test_batched_nms_matches_jax(seed, n, n_cls, thr):
    boxes, scores, classes, valid = _nms_case(seed, n, n_cls)
    jo, jk = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                              jnp.asarray(classes), jnp.asarray(valid), thr)
    to, tk = tnms.batched_nms(torch.as_tensor(boxes), torch.as_tensor(scores),
                              torch.as_tensor(classes).long(),
                              torch.as_tensor(valid), thr)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    k = 25
    js, jv = jnms.take_first_kept(jo, jk, k)
    ts, tv = tnms.take_first_kept(to, tk, k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy()[tv.numpy()],
                                  np.asarray(js)[np.asarray(jv)])


def test_batched_nms_is_sequential_greedy():
    """The fixed-point form equals the textbook sequential sweep."""
    boxes, scores, classes, valid = _nms_case(3, 90, 2)
    order, keep = tnms.batched_nms(torch.as_tensor(boxes),
                                   torch.as_tensor(scores),
                                   torch.as_tensor(classes).long(),
                                   torch.as_tensor(valid), 0.4)
    iou = tnms.box_iou(torch.as_tensor(boxes), torch.as_tensor(boxes)).numpy()
    kept = []
    for i in order.numpy():
        if not valid[i]:
            continue
        if all(not (classes[j] == classes[i] and iou[j, i] > 0.4)
               for j in kept):
            kept.append(i)
    assert sorted(kept) == sorted(order.numpy()[keep.numpy()].tolist())


def test_conv_transpose_2x2_s2_matches_jax_and_torch():
    from no_time_to_train_tpu.models.sam2.common import (
        conv_transpose_2x2_s2 as j_convt)
    from no_time_to_train_tpu_torch.models.sam2.common import (
        conv_transpose_2x2_s2)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 6, 16)).astype(np.float32)
    k = rng.standard_normal((16, 8, 2, 2)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    got = conv_transpose_2x2_s2(torch.as_tensor(x), torch.as_tensor(k),
                                torch.as_tensor(b))
    ref = np.asarray(j_convt(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    direct = torch.nn.functional.conv_transpose2d(
        torch.as_tensor(x).permute(0, 3, 1, 2), torch.as_tensor(k),
        torch.as_tensor(b), stride=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_position_encodings_match_jax():
    from no_time_to_train_tpu.models.sam2 import pos_enc as jpe
    from no_time_to_train_tpu_torch.models.sam2 import pos_enc as tpe
    np.testing.assert_allclose(
        tpe.sine_pos_embed_2d(8, 12, 64).numpy(),
        np.asarray(jpe.sine_pos_embed_2d(8, 12, 64)), rtol=1e-6, atol=1e-6)
    g = np.random.default_rng(5).standard_normal((2, 32)).astype(np.float32)
    np.testing.assert_allclose(
        tpe.random_pe_grid(6, 9, torch.as_tensor(g)).numpy(),
        np.asarray(jpe.random_pe_grid(6, 9, jnp.asarray(g))),
        rtol=1e-5, atol=1e-5)


def _logit_stack(seed, n=5, h=24, w=32):
    """Mask logits with blobs, holes and single-pixel sprinkles, and one
    mask that is empty at every threshold."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    out = np.full((n, h, w), -3.0, np.float32)
    for i in range(n - 1):
        cy, cx, r = rng.uniform(6, 18), rng.uniform(6, 26), rng.uniform(3, 8)
        out[i] = 4.0 * (r - np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2))
        out[i] += rng.standard_normal((h, w)).astype(np.float32)
        y, x = int(cy), int(cx)
        out[i, y:y + 2, x:x + 2] = -2.0                # a hole
        out[i, rng.integers(0, h), rng.integers(0, w)] = 2.5   # a sprinkle
    return out


@pytest.mark.parametrize("threshold,offset", [(0.0, 1.0), (0.5, 2.0)])
def test_stability_score_matches_jax(threshold, offset):
    """Exact: the same counts in both packages (the empty last mask gives
    0 / 0 in both)."""
    x = _logit_stack(6)
    ref = np.asarray(jmasks.stability_score(jnp.asarray(x), threshold, offset))
    got = tmasks.stability_score(torch.as_tensor(x), threshold, offset)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_mask_iou_matrix_matches_jax():
    """Exact: integer counts in float32, one division; a pair of empty masks
    gives 0."""
    a = _logit_stack(7) > 0
    b = np.concatenate([_logit_stack(8)[:3] > 0, a[:2]])
    ref = np.asarray(jmasks.mask_iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = tmasks.mask_iou_matrix(torch.as_tensor(a), torch.as_tensor(b))
    assert got.shape == (5, 5)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_allclose(np.diag(got.numpy()[:2, 3:]), 1.0)
    assert got[4, 4] == 0


@pytest.mark.parametrize("hole,sprinkle,threshold", [
    (4.0, 0.0, 0.0), (0.0, 2.0, 0.0), (6.0, 3.0, 0.0), (6.0, 3.0, 0.5)])
def test_postprocess_masks_cc_matches_jax(hole, sprinkle, threshold):
    """Exact: the same components and areas, then the same constant
    written; with both areas above 0 the holes are filled before the
    sprinkles are looked for, as in the JAX package."""
    from no_time_to_train_tpu.ops import connected_components as jcc
    from no_time_to_train_tpu_torch.ops import connected_components as tcc
    x = _logit_stack(9).reshape(1, 5, 24, 32)
    ref = np.asarray(jcc.postprocess_masks_cc(jnp.asarray(x), threshold,
                                              hole, sprinkle))
    got = tcc.postprocess_masks_cc(torch.as_tensor(x), threshold, hole,
                                   sprinkle)
    assert (ref != x).any()
    np.testing.assert_array_equal(got.numpy(), ref)
