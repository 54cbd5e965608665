"""The port's own copy of `no_time_to_train_tpu/data/tide.py`, so that the
port imports nothing of the JAX package.

Native TIDE-style detection error analysis (reference coco_ref_dataset.py
:641-648 runs the external `tidecv` package for the default_classes split;
this is a self-contained equivalent of its error taxonomy).

Classifies every non-TP prediction at the pos_thresh=0.5 operating point into
the TIDE categories (Bolya et al., ECCV 2020):

  Cls  — localized on a GT (IoU >= 0.5) of the WRONG class
  Loc  — right class, mislocalized (0.1 <= IoU < 0.5)
  Both — wrong class and mislocalized (0.1 <= IoU < 0.5)
  Dupe — would be a TP but its GT is already matched by a higher-scoring det
  Bkg  — IoU < 0.1 with every GT (background fired)
  Miss — GT never matched and not covered by a Cls/Loc/Both error

Reports per-type counts and rates for `bbox` and `segm` modes. (The external
package also reports oracle delta-AP per type; counts cover the same
diagnostic use and need no extra AP sweeps.)"""
from collections import defaultdict

import numpy as np


def _box_iou(a, b):
    """a [N,4], b [M,4] xywh -> [N, M]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    ax1, ay1 = a[:, 0], a[:, 1]
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx1, by1 = b[:, 0], b[:, 1]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    ix = np.maximum(0, np.minimum(ax2[:, None], bx2[None]) -
                    np.maximum(ax1[:, None], bx1[None]))
    iy = np.maximum(0, np.minimum(ay2[:, None], by2[None]) -
                    np.maximum(ay1[:, None], by1[None]))
    inter = ix * iy
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] - inter
    return inter / np.maximum(union, 1e-9)


def _mask_iou(dets, gts, coco):
    from no_time_to_train_tpu_torch.data.rle import iou_rle
    d_rles = [d["segmentation"] for d in dets]
    g_rles = [coco.annToRLE(g) for g in gts]
    return np.asarray(iou_rle(d_rles, g_rles, [0] * len(g_rles)))


def tide_errors(coco_gt, results, mode="bbox", pos_thresh=0.5,
                bkg_thresh=0.1):
    """coco_gt: data.coco_api.COCO; results: list of COCO result records.
    Returns dict of error counts + totals."""
    by_img = defaultdict(list)
    for r in results:
        by_img[r["image_id"]].append(r)

    counts = dict(TP=0, Cls=0, Loc=0, Both=0, Dupe=0, Bkg=0, Miss=0,
                  n_dets=0, n_gt=0)
    for img_id in coco_gt.getImgIds():
        gts = [g for g in coco_gt.loadAnns(coco_gt.getAnnIds(imgIds=[img_id]))
               if not g.get("iscrowd", 0)]
        dets = sorted(by_img.get(img_id, []),
                      key=lambda d: -d.get("score", 0.0))
        counts["n_gt"] += len(gts)
        counts["n_dets"] += len(dets)
        if not dets:
            counts["Miss"] += len(gts)
            continue
        if mode == "bbox":
            dboxes = np.array([d["bbox"] for d in dets], np.float64)
            gboxes = (np.array([g["bbox"] for g in gts], np.float64)
                      if gts else np.zeros((0, 4)))
            ious = _box_iou(dboxes, gboxes)
        else:
            ious = _mask_iou(dets, gts, coco_gt)

        g_cat = np.array([g["category_id"] for g in gts])
        g_used = np.zeros(len(gts), bool)
        g_covered = np.zeros(len(gts), bool)   # involved in any error/TP
        for i, d in enumerate(dets):
            same = (g_cat == d["category_id"]) if len(gts) else \
                np.zeros(0, bool)
            iou_row = ious[i] if len(gts) else np.zeros(0)
            # TP: best same-class unused GT above threshold
            cand = np.where(same & ~g_used & (iou_row >= pos_thresh))[0]
            if len(cand):
                j = cand[np.argmax(iou_row[cand])]
                g_used[j] = g_covered[j] = True
                counts["TP"] += 1
                continue
            iou_cls = float(iou_row[same].max()) if same.any() else 0.0
            iou_other = (float(iou_row[~same].max()) if (~same).any()
                         else 0.0)
            if iou_other >= pos_thresh:
                counts["Cls"] += 1
                g_covered[(~same) & (iou_row >= pos_thresh)] = True
            elif bkg_thresh <= iou_cls < pos_thresh:
                counts["Loc"] += 1
                g_covered[same & (iou_row >= bkg_thresh)] = True
            elif iou_cls >= pos_thresh:
                counts["Dupe"] += 1
            elif bkg_thresh <= iou_other < pos_thresh:
                counts["Both"] += 1
                g_covered[(~same) & (iou_row >= bkg_thresh)] = True
            else:
                counts["Bkg"] += 1
        counts["Miss"] += int((~g_used & ~g_covered).sum())
    return counts


def summarize(counts, mode="bbox"):
    n = max(counts["n_dets"], 1)
    print(f"-- TIDE-style error analysis ({mode}, pos_thresh=0.5) --")
    print(f"   dets={counts['n_dets']}  gt={counts['n_gt']}  "
          f"TP={counts['TP']}")
    for k in ("Cls", "Loc", "Both", "Dupe", "Bkg"):
        print(f"   {k:5s}: {counts[k]:6d}  ({100.0 * counts[k] / n:5.1f}% "
              f"of dets)")
    ng = max(counts["n_gt"], 1)
    print(f"   Miss : {counts['Miss']:6d}  ({100.0 * counts['Miss'] / ng:5.1f}"
          f"% of gt)")
    return counts


def evaluate_tide(coco_gt, results, modes=("bbox", "segm")):
    """Run both modes like the reference's tide.evaluate_range BOX + MASK."""
    out = {}
    for mode in modes:
        out[mode] = summarize(tide_errors(coco_gt, results, mode=mode), mode)
    return out
