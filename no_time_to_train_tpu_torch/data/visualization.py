"""Visualization (port of `no_time_to_train_tpu/data/visualization.py`,
itself after the reference's dataset/visualization.py and the memory-bank
overlays of matching_baseline_utils.py:188-350).

GT-vs-prediction side-by-side panels, per-dataset palettes, mask overlays,
and the k-means / PCA memory visualizations, drawn with numpy on uint8
[H, W, 3] arrays: images are read by `image_io.read_rgb` and written by
`image_io.save_png`. Box outlines follow PIL's `ImageDraw.rectangle` pixel
rule, the nearest-neighbour resize PIL's `Image.resize(..., NEAREST)`
source index, and the blend PIL's `Image.blend` arithmetic, so every pixel
equals the JAX package's outside the labels. Labels are drawn with the
5 x 7 bitmap font below, where the JAX package uses PIL's default font; a
label is anchored where the JAX package anchors it.
"""
import os

import numpy as np

from no_time_to_train_tpu_torch.data.image_io import read_rgb, save_png

PALETTES = {
    "coco": [(220, 20, 60), (0, 82, 0), (0, 182, 199), (255, 160, 122),
             (119, 11, 32), (0, 60, 100), (0, 0, 230), (106, 0, 228),
             (60, 179, 113), (255, 215, 0)],
    "default": [(230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
                (245, 130, 48), (145, 30, 180), (70, 240, 240),
                (240, 50, 230), (210, 245, 60), (250, 190, 190)],
}

# 5 x 7 glyphs of printable ASCII (32-126), five column bytes each, bit 0
# the top row; a glyph advances GLYPH_ADVANCE pixels
_GLYPHS = (
    "0000000000 00005f0000 0007000700 147f147f14 242a7f2a12 2313086462 "
    "3649552250 0005030000 001c224100 0041221c00 082a1c2a08 08083e0808 "
    "0050300000 0808080808 0060600000 2010080402 3e5149453e 00427f4000 "
    "4261514946 2141454b31 1814127f10 2745454539 3c4a494930 0171090503 "
    "3649494936 064949291e 0036360000 0056360000 0008142241 1414141414 "
    "4122140800 0201510906 324979413e 7e1111117e 7f49494936 3e41414122 "
    "7f4141221c 7f49494941 7f09090101 3e41415132 7f0808087f 00417f4100 "
    "2040413f01 7f08142241 7f40404040 7f0204027f 7f0408107f 3e4141413e "
    "7f09090906 3e4151215e 7f09192946 4649494931 01017f0101 3f4040403f "
    "1f2040201f 7f2018207f 6314081463 0304780403 6151494543 007f414100 "
    "0204081020 0041417f00 0402010204 4040404040 0001020400 2054545478 "
    "7f48444438 3844444420 384444487f 3854545418 087e090102 081454543c "
    "7f08040478 00447d4000 2040443d00 007f102844 00417f4000 7c04180478 "
    "7c08040478 3844444438 7c14141408 081414187c 7c08040408 4854545420 "
    "043f444020 3c4040207c 1c2040201c 3c4030403c 4428102844 0c5050503c "
    "4464544c44 0008364100 00007f0000 0041360800 0804080408").split()
FONT = {chr(32 + i): bytes.fromhex(g) for i, g in enumerate(_GLYPHS)}
GLYPH_W, GLYPH_H, GLYPH_ADVANCE = 5, 7, 6


def _color(idx, dataset_name=None):
    pal = PALETTES.get(dataset_name or "default", PALETTES["default"])
    return pal[idx % len(pal)]


def _hline(img, x0, y, x1, color):
    h, w = img.shape[:2]
    if not 0 <= y < h:
        return
    x0, x1 = min(x0, x1), max(x0, x1)
    x0, x1 = max(x0, 0), min(x1, w - 1)
    if x0 <= x1:
        img[y, x0:x1 + 1] = color


def _vline(img, x, y0, y1, color):
    """PIL's `line` at dx = 0: |y1 - y0| points from y0 towards y1, the end
    point left out."""
    h, w = img.shape[:2]
    if not 0 <= x < w or y0 == y1:
        return
    lo, hi = (y0, y1 - 1) if y1 > y0 else (y1 + 1, y0)
    lo, hi = max(lo, 0), min(hi, h - 1)
    if lo <= hi:
        img[lo:hi + 1, x] = color


def draw_rectangle(img, box, color, width=1):
    """Outline of the XYXY box on img [H, W, 3] in place, pixel for pixel
    PIL's `ImageDraw.rectangle(box, outline=color, width=width)`: corners
    truncated towards zero, `width` rows at the top and bottom, `width`
    columns at the sides between them."""
    x0, y0, x1, y1 = (int(float(v)) for v in box)
    if x1 < x0 or y1 < y0:
        raise ValueError(f"box {box}: x1 must be >= x0 and y1 >= y0")
    for i in range(max(width, 1)):
        _hline(img, x0, y0 + i, x1, color)
        _hline(img, x0, y1 - i, x1, color)
        _vline(img, x1 - i, y0 + width, y1 - width + 1, color)
        _vline(img, x0 + i, y0 + width, y1 - width + 1, color)


def text_box(xy, text):
    """(x0, y0, x1, y1), right and bottom exclusive, of the pixels that
    `draw_text(img, xy, text, ...)` may set (before clipping to the
    image)."""
    x0, y0 = int(float(xy[0])), int(float(xy[1]))
    if not text:
        return x0, y0, x0, y0
    return (x0, y0, x0 + GLYPH_ADVANCE * (len(text) - 1) + GLYPH_W,
            y0 + GLYPH_H)


def draw_text(img, xy, text, color, font=None):
    """text in the bitmap font, its top left corner at xy (truncated towards
    zero), on img in place. font: {char: five column bytes}, FONT by
    default; a character it lacks is drawn as '?'."""
    font = FONT if font is None else font
    h, w = img.shape[:2]
    x0, y0 = int(float(xy[0])), int(float(xy[1]))
    rows = np.arange(GLYPH_H)
    for k, ch in enumerate(text):
        cols = font.get(ch, font["?"])
        for c, bits in enumerate(cols):
            x = x0 + GLYPH_ADVANCE * k + c
            if not 0 <= x < w:
                continue
            ys = y0 + rows[(bits >> rows) & 1 == 1]
            ys = ys[(ys >= 0) & (ys < h)]
            img[ys, x] = color


def draw_box_on_image(img, box, color, width=2, label=None, font=None):
    """reference visualization.py:19 — XYXY box + optional label, on img
    [H, W, 3] uint8 in place."""
    x1, y1, _, _ = (float(v) for v in box)
    draw_rectangle(img, box, color, width=width)
    if label:
        draw_text(img, (x1 + 2, max(0, y1 - 12)), label, color, font=font)


def _overlay_masks(img, masks, labels, alpha=0.5, dataset_name=None):
    """img [H, W, 3] uint8 -> uint8 with each mask blended in its label's
    colour."""
    base = np.asarray(img).astype(np.float32)
    for i, m in enumerate(masks):
        color = np.asarray(_color(int(labels[i]) if labels is not None else i,
                                  dataset_name), np.float32)
        mb = np.asarray(m, bool)
        base[mb] = base[mb] * (1 - alpha) + color * alpha
    return base.clip(0, 255).astype(np.uint8)


def _names(labels, class_names):
    return [class_names[lab] if class_names and lab < len(class_names)
            else str(lab) for lab in labels]


def coco_panel_labels(gt_labels, n_gt, scores, labels, score_thr,
                      show_scores=False, class_names=None):
    """The label texts of vis_coco's two panels: (GT texts, kept
    prediction indices, prediction texts)."""
    gt_labs = [int(gt_labels[i]) if i < len(gt_labels) else 0
               for i in range(n_gt)]
    keep = [i for i in range(len(scores)) if scores[i] >= score_thr]
    names = _names([int(labels[i]) for i in keep], class_names)
    texts = [f"{n} {scores[i]:.2f}" if show_scores else n
             for n, i in zip(names, keep)]
    return _names(gt_labs, class_names), keep, texts


def vis_coco(gt_bboxes, gt_labels, gt_masks, scores, labels, bboxes,
             masks_pred, score_thr, img_path, out_path, show_scores=False,
             dataset_name=None, class_names=None):
    """GT-vs-pred side-by-side panel (reference visualization.py:94),
    written as a PNG under out_path's name."""
    img = read_rgb(img_path)
    h, w = img.shape[:2]
    n_gt = len(gt_bboxes) if len(gt_bboxes) else 0
    gt_texts, keep, pred_texts = coco_panel_labels(
        gt_labels, n_gt, scores, labels, score_thr, show_scores, class_names)

    gt_panel = img.copy()
    if len(gt_masks):
        gt_panel = _overlay_masks(gt_panel, gt_masks, gt_labels,
                                  dataset_name=dataset_name)
    for i in range(n_gt):
        lab = int(gt_labels[i]) if i < len(gt_labels) else 0
        draw_box_on_image(gt_panel, gt_bboxes[i], _color(lab, dataset_name),
                          label=gt_texts[i])

    pred_panel = img.copy()
    if keep and len(masks_pred):
        pred_panel = _overlay_masks(pred_panel,
                                    [masks_pred[i] for i in keep],
                                    [labels[i] for i in keep],
                                    dataset_name=dataset_name)
    for i, text in zip(keep, pred_texts):
        draw_box_on_image(pred_panel, bboxes[i],
                          _color(int(labels[i]), dataset_name), label=text)

    canvas = np.full((h, w * 2 + 5, 3), 255, np.uint8)
    canvas[:, :w] = gt_panel
    canvas[:, w + 5:] = pred_panel
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    save_png(out_path, canvas)
    return out_path


def nearest_index(n_in, n_out):
    """Source indices of PIL's nearest-neighbour resize along one axis: the
    output centre (i + 0.5) * n_in / n_out, accumulated in float64 as PIL's
    ImagingScaleAffine does, truncated."""
    s = n_in / n_out
    pos = np.cumsum(np.concatenate([[s * 0.5], np.full(n_out - 1, s)]))
    return pos.astype(np.int64)


def resize_nearest(img, size):
    """PIL's `Image.fromarray(img).resize((w, h), Image.NEAREST)`, bit for
    bit; size (h, w)."""
    h, w = size
    img = np.asarray(img)
    return img[nearest_index(img.shape[0], h)][:, nearest_index(img.shape[1],
                                                                w)]


def blend(a, b, alpha):
    """PIL's `Image.blend(a, b, alpha)` on uint8 arrays: a + alpha (b - a)
    in float32, truncated."""
    a32, b32 = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a32 + np.float32(alpha) * (b32 - a32)).astype(np.uint8)


def vis_results_online(output, tar_anns_by_cat, ori_hw, img_path, out_dir,
                       score_thr=0.5, show_scores=True, dataset_name=None,
                       class_names=None):
    """Reference matching_baseline_utils.vis_results_online (:753-829):
    render one image's predictions vs GT to results_analysis/<dataset>/.

    tar_anns_by_cat carries GT at the square model input size; predictions
    are at the original size — GT boxes/masks are rescaled to ori_hw here."""
    ori_h, ori_w = ori_hw
    gt_masks, gt_boxes, gt_labels = [], [], []
    for cat_ind, e in (tar_anns_by_cat or {}).items():
        for j in range(len(e.get("bboxes", []))):
            box = np.asarray(e["bboxes"][j], np.float64)
            s = e["masks"][j].shape[-1] if "masks" in e else None
            if s:
                box = box * np.array([ori_w / s, ori_h / s] * 2)
            gt_boxes.append(box)
            gt_labels.append(cat_ind)
            if "masks" in e:
                m = np.asarray(e["masks"][j]) > 0.5
                gt_masks.append(resize_nearest(m, (ori_h, ori_w)))
    out_path = os.path.join(out_dir, os.path.basename(img_path))
    return vis_coco(gt_boxes, gt_labels, gt_masks, output["scores"],
                    output["labels"], output["bboxes"],
                    output["binary_masks"], score_thr, img_path, out_path,
                    show_scores=show_scores, dataset_name=dataset_name,
                    class_names=class_names)


def vis_pca(ref_img, ref_feats_grid, pca_mean, pca_components):
    """Project per-patch features onto 3 PCA components -> RGB heatmap
    blended over ref_img [H, W, 3] uint8 (reference vis_pca :253-310).
    ref_feats_grid: [gh, gw, D]."""
    gh, gw, d = ref_feats_grid.shape
    flat = ref_feats_grid.reshape(-1, d) - pca_mean[None]
    proj = flat @ np.asarray(pca_components).T  # [N, 3]
    lo, hi = proj.min(0), proj.max(0)
    rgb = (proj - lo) / np.maximum(hi - lo, 1e-6)
    rgb = (rgb.reshape(gh, gw, 3) * 255).astype(np.uint8)
    return blend(ref_img, resize_nearest(rgb, ref_img.shape[:2]), 0.7)


def vis_kmeans(ref_img, ref_feats_grid, centers):
    """Color patches by nearest (cosine) k-means center, blended over
    ref_img [H, W, 3] uint8 (reference vis_kmeans :188-252)."""
    gh, gw, d = ref_feats_grid.shape
    flat = ref_feats_grid.reshape(-1, d)
    fn = flat / np.maximum(np.linalg.norm(flat, axis=-1, keepdims=True), 1e-9)
    cn = centers / np.maximum(np.linalg.norm(centers, axis=-1, keepdims=True),
                              1e-9)
    assign = (fn @ cn.T).argmax(-1)
    colors = np.array([_color(i) for i in range(len(centers))], np.uint8)
    rgb = colors[assign].reshape(gh, gw, 3)
    return blend(ref_img, resize_nearest(rgb, ref_img.shape[:2]), 0.7)


def _host(x):
    """A bank field (a tensor, on any device) as a numpy array."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def vis_memory(ref_img_np, ref_feats_grid, cat_ind, bank, out_dir,
               img_id=0):
    """Side-by-side original | k-means | PCA overlay of one reference
    (reference vis_memory :663-751), written to <out_dir>/<cat>_<id>.png."""
    os.makedirs(out_dir, exist_ok=True)
    img = (np.asarray(ref_img_np) * 255).astype(np.uint8)
    km = vis_kmeans(img, ref_feats_grid, _host(bank.feats_centers[cat_ind]))
    pc = vis_pca(img, ref_feats_grid, _host(bank.pca_mean[cat_ind]),
                 _host(bank.pca_components[cat_ind]))
    h, w = img.shape[:2]
    canvas = np.full((h, w * 3 + 10, 3), 255, np.uint8)
    canvas[:, :w] = img
    canvas[:, w + 5:2 * w + 5] = km
    canvas[:, 2 * w + 10:] = pc
    path = os.path.join(out_dir, f"{cat_ind}_{img_id}.png")
    save_png(path, canvas)
    return path
