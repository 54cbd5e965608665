"""The port's own copy of `no_time_to_train_tpu/data/data_utils.py`, so that the
port imports nothing of the JAX package.

Annotation validity + false-positive mining (reference
no_time_to_train/dataset/data_utils.py)."""
import numpy as np


def is_valid_annotation(ann, img_info, min_box_size=32, border_margin=10):
    """Reference data_utils.py:35 — no crowd, bbox >= 32px each side, and at
    least 10px from all image borders."""
    if ann.get("iscrowd", 0):
        return False
    x, y, w, h = ann["bbox"]
    if w < min_box_size or h < min_box_size:
        return False
    iw, ih = img_info["width"], img_info["height"]
    if (x < border_margin or y < border_margin
            or x + w > iw - border_margin or y + h > ih - border_margin):
        return False
    return True


def compute_box_iou_mat(boxes_a, boxes_b):
    """xywh boxes -> IoU matrix (reference data_utils.py:67)."""
    a = np.asarray(boxes_a, np.float64).reshape(-1, 4)
    b = np.asarray(boxes_b, np.float64).reshape(-1, 4)
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    iw = np.clip(np.minimum(ax2[:, None], bx2) - np.maximum(a[:, None, 0],
                                                            b[:, 0]), 0, None)
    ih = np.clip(np.minimum(ay2[:, None], by2) - np.maximum(a[:, None, 1],
                                                            b[:, 1]), 0, None)
    inter = iw * ih
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3]) - inter
    return np.where(union > 0, inter / union, 0.0)


def get_false_positives(results, annotations, cat_ids, iou_thr=0.1,
                        use_mask_iou=False):
    """Detections that overlap no GT of any class above iou_thr, bucketed by
    predicted category (reference data_utils.py:90)."""
    fps = {c: [] for c in cat_ids}
    gt_boxes = [a["bbox"] for a in annotations]
    for res in results:
        if gt_boxes:
            ious = compute_box_iou_mat([res["bbox"]], gt_boxes)[0]
            if ious.max() > iou_thr:
                continue
        fps[res["category_id"]].append(res)
    return fps
