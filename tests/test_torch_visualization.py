"""The port's drawing (`no_time_to_train_tpu_torch/data/visualization.py`,
`tools/plot_reference_images.py`) against the JAX package's PIL drawing,
and the port's cv2-equivalent resizes (`data/image_io.py`) against OpenCV.

The port draws on uint8 arrays with numpy; the JAX package with PIL. Every
pixel must be equal, bit for bit, outside the label text: there the JAX
package draws PIL's default (FreeType) font and the port its 5 x 7 bitmap
font, so each label's box is left out of the comparison, the union of PIL's
`ImageDraw.textbbox` and the port's `text_box`. Inside each label box the
port must have drawn every pixel of its glyphs in the label's colour (the
labels here overlap nothing drawn after them).

The resizes are held to `cv2.resize` bit for bit (INTER_LINEAR on float32,
INTER_NEAREST on uint8), at up- and downscales and at 256 -> 1333 x 800,
and `read_gray` to PIL's `convert("L")`.
"""
import json
import os
import types

import cv2
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from no_time_to_train_tpu.data import rle as jrle
from no_time_to_train_tpu.data import visualization as jvis
from no_time_to_train_tpu_torch.data import visualization as tvis
from no_time_to_train_tpu_torch.data.image_io import (
    read_gray, read_rgb, resize_linear_cv2, resize_nearest_cv2)
from no_time_to_train_tpu_torch.tools.plot_reference_images import (
    plot_reference_images as t_plot_reference_images)
from tools.make_plots.plot_reference_images import (
    plot_reference_images as j_plot_reference_images)

H, W = 72, 96
NAMES = ["person", "car", "traffic light", "dog"]


def _label_xy(box):
    return float(box[0]) + 2, max(0, float(box[1]) - 12)


def _label_boxes(boxes, texts, x_off=0):
    """Both packages' label boxes (x0, y0, x1, y1, right and bottom
    exclusive) of the labels draw_box_on_image draws for these boxes."""
    draw = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    out = []
    for box, text in zip(boxes, texts):
        xy = _label_xy(box)
        jb = draw.textbbox(xy, text)
        out.append((int(np.floor(jb[0])) + x_off, int(np.floor(jb[1])),
                    int(np.ceil(jb[2])) + x_off, int(np.ceil(jb[3]))))
        tb = tvis.text_box(xy, text)
        out.append((tb[0] + x_off, tb[1], tb[2] + x_off, tb[3]))
    return out


def _assert_same_outside(got, want, boxes):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    keep = np.ones(got.shape[:2], bool)
    for x0, y0, x1, y1 in boxes:
        keep[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = False
    assert keep.mean() > 0.5
    bad = np.argwhere((got != want).any(-1) & keep)
    assert len(bad) == 0, f"{len(bad)} pixels differ, first {bad[:5]}"


def _assert_glyphs(img, boxes, texts, colors, x_off=0):
    """Every glyph pixel of each label is in its colour."""
    for box, text, color in zip(boxes, texts, colors):
        blank = np.zeros(img.shape[:2] + (3,), np.uint8)
        x, y = _label_xy(box)
        tvis.draw_text(blank[:, x_off:], (x, y), text, (255, 255, 255))
        on = blank[..., 0] > 0
        assert on.any()
        assert (img[on] == np.asarray(color, np.uint8)).all(), text


def _image(tmp_path, rng, name="img.png", h=H, w=W):
    path = str(tmp_path / name)
    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(path)
    return path


def _case(rng):
    """GT and predictions whose labels sit apart: one box at the top edge
    (its label clamped to y = 0), one whose label runs off the right edge,
    one below the score threshold, a fractional and a thin box."""
    gt_boxes = np.array([[3.7, 2.2, 30.1, 25.9], [60.5, 40.2, 94.0, 70.6]])
    gt_masks = rng.random((2, H, W)) > 0.6
    pred_boxes = np.array([[5.2, 30.6, 28.9, 50.1], [70.3, 40.8, 95.0, 52.3],
                           [40.0, 50.0, 44.4, 51.0], [35.5, 58.2, 36.1, 70.9]])
    masks_pred = rng.random((4, H, W)) > 0.5
    scores = np.array([0.91, 0.62, 0.3, 0.77], np.float32)
    labels = np.array([0, 2, 1, 3])
    return dict(gt_bboxes=gt_boxes, gt_labels=[1, 3], gt_masks=gt_masks,
                scores=scores, labels=labels, bboxes=pred_boxes,
                masks_pred=masks_pred, score_thr=0.5)


def _coco_label_boxes(case, w, show_scores, class_names, dataset_name=None):
    gt_texts, keep, pred_texts = tvis.coco_panel_labels(
        case["gt_labels"], len(case["gt_bboxes"]), case["scores"],
        case["labels"], case["score_thr"], show_scores, class_names)
    pred_boxes = [case["bboxes"][i] for i in keep]
    boxes = (_label_boxes(case["gt_bboxes"], gt_texts)
             + _label_boxes(pred_boxes, pred_texts, x_off=w + 5))
    colors = ([tvis._color(int(c), dataset_name) for c in case["gt_labels"]],
              [tvis._color(int(case["labels"][i]), dataset_name)
               for i in keep])
    return boxes, (gt_texts, pred_boxes, pred_texts), colors


@pytest.mark.parametrize("show_scores,dataset_name,class_names", [
    (True, None, NAMES), (False, "coco", None), (True, "coco", NAMES[:2])])
def test_vis_coco_matches_jax(tmp_path, rng, show_scores, dataset_name,
                              class_names):
    img = _image(tmp_path, rng)
    case = _case(rng)
    kw = dict(case, img_path=img, show_scores=show_scores,
              dataset_name=dataset_name, class_names=class_names)
    jvis.vis_coco(**kw, out_path=str(tmp_path / "j" / "vis.png"))
    tvis.vis_coco(**kw, out_path=str(tmp_path / "t" / "vis.png"))
    want = np.asarray(Image.open(tmp_path / "j" / "vis.png").convert("RGB"))
    got = read_rgb(str(tmp_path / "t" / "vis.png"))
    boxes, (gt_texts, pred_boxes, pred_texts), colors = _coco_label_boxes(
        case, W, show_scores, class_names, dataset_name)
    _assert_same_outside(got, want, boxes)
    _assert_glyphs(got, case["gt_bboxes"][:1], gt_texts[:1], colors[0][:1])
    _assert_glyphs(got, pred_boxes, pred_texts, colors[1], x_off=W + 5)


def test_draw_rectangle_follows_pil(rng):
    """PIL's outline rule on 600 random boxes: fractional and negative
    corners, boxes off the image, boxes thinner than the outline."""
    for t in range(600):
        x0, x1 = np.sort(rng.uniform(-15, 65, 2))
        y0, y1 = np.sort(rng.uniform(-15, 55, 2))
        if t % 4 == 0:
            x1, y1 = x0 + rng.uniform(0, 3), y0 + rng.uniform(0, 3)
        width = int(rng.integers(1, 5))
        im = Image.new("RGB", (50, 40))
        ImageDraw.Draw(im).rectangle([x0, y0, x1, y1], outline=(9, 200, 7),
                                     width=width)
        got = np.zeros((40, 50, 3), np.uint8)
        tvis.draw_rectangle(got, (x0, y0, x1, y1), (9, 200, 7), width)
        np.testing.assert_array_equal(got, np.asarray(im))


def test_overlay_masks_matches_jax(rng):
    img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    masks = rng.random((3, H, W)) > 0.5
    for labels, alpha, name in (([2, 0, 7], 0.5, None), (None, 0.3, "coco")):
        want = jvis._overlay_masks(Image.fromarray(img), masks, labels,
                                   alpha=alpha, dataset_name=name)
        got = tvis._overlay_masks(img, masks, labels, alpha=alpha,
                                  dataset_name=name)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("grid,size", [((5, 7), (72, 96)), ((37, 37),
                                                            (518, 518)),
                                       ((4, 4), (30, 17))])
def test_vis_pca_and_kmeans_match_jax(rng, grid, size):
    gh, gw = grid
    img = (rng.random(size + (3,)) * 255).astype(np.uint8)
    feats = rng.standard_normal((gh, gw, 16)).astype(np.float32)
    mean = rng.standard_normal(16).astype(np.float32)
    comps = rng.standard_normal((3, 16)).astype(np.float32)
    centers = rng.standard_normal((4, 16)).astype(np.float32)
    pil = Image.fromarray(img)
    np.testing.assert_array_equal(
        tvis.vis_pca(img, feats, mean, comps),
        np.asarray(jvis.vis_pca(pil, feats, mean, comps)))
    np.testing.assert_array_equal(
        tvis.vis_kmeans(img, feats, centers),
        np.asarray(jvis.vis_kmeans(pil, feats, centers)))


def test_resize_nearest_and_blend_follow_pil(rng):
    for _ in range(100):
        gh, gw = rng.integers(1, 40, 2)
        h, w = rng.integers(1, 600, 2)
        a = rng.integers(0, 256, (gh, gw, 3)).astype(np.uint8)
        want = np.asarray(Image.fromarray(a).resize((int(w), int(h)),
                                                    Image.NEAREST))
        np.testing.assert_array_equal(tvis.resize_nearest(a, (h, w)), want)
    a = rng.integers(0, 256, (64, 80, 3)).astype(np.uint8)
    b = rng.integers(0, 256, (64, 80, 3)).astype(np.uint8)
    for alpha in (0.7, 0.5, 0.25):
        want = Image.blend(Image.fromarray(a), Image.fromarray(b), alpha)
        np.testing.assert_array_equal(tvis.blend(a, b, alpha),
                                      np.asarray(want))


def test_vis_memory_matches_jax(tmp_path, rng):
    gs, d = 6, 16
    ref = rng.random((84, 84, 3)).astype(np.float32)
    feats = rng.standard_normal((gs, gs, d)).astype(np.float32)
    fields = dict(feats_centers=rng.standard_normal((2, 4, d)),
                  pca_mean=rng.standard_normal((2, d)),
                  pca_components=rng.standard_normal((2, 3, d)))
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    jbank = types.SimpleNamespace(**fields)
    tbank = types.SimpleNamespace(
        **{k: torch.from_numpy(v) for k, v in fields.items()})
    jp = jvis.vis_memory(ref, feats, 1, jbank, str(tmp_path / "j"), img_id=7)
    tp = tvis.vis_memory(ref, feats, 1, tbank, str(tmp_path / "t"), img_id=7)
    assert os.path.basename(jp) == os.path.basename(tp) == "1_7.png"
    np.testing.assert_array_equal(read_rgb(tp),
                                  np.asarray(Image.open(jp).convert("RGB")))


def test_vis_results_online_matches_jax(tmp_path, rng):
    """GT at the square model size, rescaled to the original size (boxes by
    the size ratio, masks by PIL's nearest resize)."""
    img = _image(tmp_path, rng, "q.png", h=60, w=90)
    s = 32
    gt = {0: {"bboxes": [np.array([2.0, 3.0, 12.5, 14.0])],
              "masks": [rng.random((s, s)).astype(np.float32)]},
          3: {"bboxes": [np.array([20.0, 18.0, 30.0, 29.0]),
                         np.array([4.0, 20.0, 9.0, 30.0])],
              "masks": list(rng.random((2, s, s)).astype(np.float32))}}
    out = dict(scores=np.array([0.8, 0.55], np.float32),
               labels=np.array([3, 1]),
               bboxes=np.array([[10.0, 30.0, 40.0, 58.0],
                                [55.0, 16.0, 88.0, 40.0]], np.float32),
               binary_masks=rng.random((2, 60, 90)) > 0.5)
    for pkg, tag in ((jvis, "j"), (tvis, "t")):
        pkg.vis_results_online(out, gt, (60, 90), img, str(tmp_path / tag),
                               score_thr=0.5, dataset_name="coco",
                               class_names=NAMES)
    want = np.asarray(Image.open(tmp_path / "j" / "q.png").convert("RGB"))
    got = read_rgb(str(tmp_path / "t" / "q.png"))
    gt_boxes = [b * np.array([90 / s, 60 / s] * 2) for c in (0, 3)
                for b in gt[c]["bboxes"]]
    gt_texts = [NAMES[0], NAMES[3], NAMES[3]]
    pred_texts = [f"{NAMES[l]} {sc:.2f}" for l, sc in zip(out["labels"],
                                                         out["scores"])]
    _assert_same_outside(got, want, _label_boxes(gt_boxes, gt_texts)
                         + _label_boxes(out["bboxes"], pred_texts, 95))


def _ref_coco(tmp_path, rng):
    images, anns = [], []
    for i in range(3):
        images.append({"id": i + 1, "height": 48, "width": 64,
                       "file_name": f"{i}.png"})
        for j in range(2):
            m = np.zeros((48, 64), np.uint8)
            m[20 + 4 * j:34 + 4 * j, 6 + 30 * j:26 + 30 * j] = 1
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": 1 + (i + j) % 3,
                         "bbox": [6.0 + 30 * j, 20.0 + 4 * j, 20.0, 14.0],
                         "area": 280.0, "iscrowd": 0,
                         "segmentation": jrle.encode_mask(m)})
    cats = [{"id": 1, "name": "cat"}, {"id": 2, "name": "dog"},
            {"id": 3, "name": "bird"}]
    path = tmp_path / "refs.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": cats}))
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for im in images:
        _image(img_dir, rng, im["file_name"], 48, 64)
    return str(path), str(img_dir), anns, cats


def test_plot_reference_images_matches_jax(tmp_path, rng):
    path, img_dir, anns, cats = _ref_coco(tmp_path, rng)
    want = j_plot_reference_images(path, img_dir, str(tmp_path / "j"))
    got = t_plot_reference_images(path, img_dir, str(tmp_path / "t"))
    assert [os.path.basename(p) for p in got] \
        == [os.path.basename(p) for p in want] \
        == ["ref_0.png", "ref_1.png", "ref_2.png"]
    for i, (g, w) in enumerate(zip(got, want)):
        a = [a for a in anns if a["image_id"] == i + 1]
        boxes = [[x, y, x + bw, y + bh] for x, y, bw, bh in
                 (a_["bbox"] for a_ in a)]
        texts = [cats[a_["category_id"] - 1]["name"] for a_ in a]
        _assert_same_outside(read_rgb(g),
                             np.asarray(Image.open(w).convert("RGB")),
                             _label_boxes(boxes, texts)
                             + _label_boxes(boxes, texts, 64 + 5))
    one = t_plot_reference_images(path, img_dir, str(tmp_path / "t2"),
                                  file_names={"1.png"})
    assert [os.path.basename(p) for p in one] == ["ref_1.png"]


@pytest.mark.parametrize("src,dst", [
    ((256, 256), (800, 1333)), ((256, 256), (1024, 1024)),
    ((256, 256), (480, 640)), ((256, 256), (64, 64)), ((64, 48), (17, 23)),
    ((5, 7), (3, 11)), ((100, 37), (300, 90)), ((1, 1), (4, 5))])
def test_cv2_resizes_match_opencv(rng, src, dst):
    x = (rng.standard_normal(src) * 8).astype(np.float32)
    want = cv2.resize(x, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(resize_linear_cv2(x, dst), want)
    m = (rng.random(src) > 0.5).astype(np.uint8)
    want = cv2.resize(m, dst[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(resize_nearest_cv2(m, dst), want)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_read_gray_follows_pil(tmp_path, rng, mode):
    """The demo's reference mask: PIL's convert("L") of any PNG."""
    rgb = Image.fromarray((rng.random((21, 34, 3)) * 255).astype(np.uint8))
    path = str(tmp_path / "m.png")
    rgb.convert(mode).save(path)
    np.testing.assert_array_equal(read_gray(path),
                                  np.asarray(Image.open(path).convert("L")))
