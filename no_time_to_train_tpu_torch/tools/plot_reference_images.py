"""Render every annotated image of a COCO-format json as a GT panel (port
of `tools/make_plots/plot_reference_images.py`, itself after the
reference's tools/make_plots/plot_reference_images.py:46-94).

Uses the port's COCO api (polygon + RLE decode) and `vis_coco`; it draws on
the host and touches no device.

    python -m no_time_to_train_tpu_torch.tools.plot_reference_images \\
        --json_path refs.json --image_dir imgs/ --output_dir out/ \\
        [--dataset_name COCO]
"""
import argparse
import os

import numpy as np

from no_time_to_train_tpu_torch.data.coco_api import COCO
from no_time_to_train_tpu_torch.data.visualization import vis_coco


def process_annotations(coco, annotations):
    """Masks/boxes/labels arrays from a list of annotation dicts
    (reference plot_reference_images.py:16-44; xywh -> xyxy)."""
    masks, bboxes, category_ids = [], [], []
    for ann in annotations:
        masks.append(coco.annToMask(ann))
        bboxes.append(ann["bbox"])
        category_ids.append(ann["category_id"])
    masks = np.stack(masks) if masks else np.zeros((0, 1, 1), bool)
    bboxes = np.asarray(bboxes, np.float64).reshape(-1, 4)
    bboxes[:, 2] += bboxes[:, 0]
    bboxes[:, 3] += bboxes[:, 1]
    scores = np.ones(len(masks))
    return masks, bboxes, np.asarray(category_ids), scores


def plot_reference_images(json_path, image_dir, output_dir,
                          dataset_name="COCO", file_names=None):
    """One `ref_<file_name>` panel per annotated image; GT drawn on both
    sides of the vis_coco canvas (the reference passes the annotations as
    both gt and pred, plot_reference_images.py:79-94). `file_names`
    optionally restricts to a hand-picked gallery."""
    os.makedirs(output_dir, exist_ok=True)
    coco = COCO(json_path)
    cat_idx = {c["id"]: i for i, c in
               enumerate(coco.loadCats(sorted(coco.cats)))}
    names = [c["name"] for c in coco.loadCats(sorted(coco.cats))]
    out_paths = []
    for image_id in sorted(coco.imgs):
        ann_ids = coco.getAnnIds(imgIds=[image_id])
        if not ann_ids:
            continue
        info = coco.imgs[image_id]
        if file_names is not None and info["file_name"] not in file_names:
            continue
        masks, bboxes, cat_ids, scores = process_annotations(
            coco, coco.loadAnns(ann_ids))
        labels = np.asarray([cat_idx[c] for c in cat_ids])
        out = os.path.join(
            output_dir, "ref_" + os.path.basename(info["file_name"]))
        vis_coco(gt_bboxes=bboxes, gt_labels=labels, gt_masks=masks,
                 scores=scores, labels=labels, bboxes=bboxes,
                 masks_pred=masks, score_thr=0.0,
                 img_path=os.path.join(image_dir, info["file_name"]),
                 out_path=out, show_scores=False,
                 dataset_name=dataset_name, class_names=names)
        out_paths.append(out)
    return out_paths


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Plot reference images with annotations")
    p.add_argument("--json_path", required=True)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--dataset_name", default="COCO")
    a = p.parse_args(argv)
    return plot_reference_images(a.json_path, a.image_dir, a.output_dir,
                                 a.dataset_name)


if __name__ == "__main__":
    main()
