"""Episodic few-shot dispersion evaluation, the `nttt` backend (port of
`scripts/eval_sam3_olive_dispersion.py`, itself after the reference's
scripts/eval_sam3_olive_dispersion.py:1-283).

For each K in --shots and each class: sample N random (K support, 1 query)
episodes, predict the query's binary class mask, and report mean IoU, std
and 95% CI per class plus the global mIoU — the dispersion (std / CI across
episodes) is the statistic of interest. The backend is the port's matching
pipeline: a fresh memory bank of one class per episode, K references
filled, post-processed, one test step on the query, the union of the masks
that score above 0.5. The reference's `sam3` backend (HuggingFace's SAM3
visual prompting) stays in the JAX-side script: it runs no code of this
system.

    python -m no_time_to_train_tpu_torch.scripts.eval_sam3_olive_dispersion \\
        --coco_json all.json --img_dir all_images/ [--shots 1,2,3,5,10] \\
        [--episodes 1000] [--sam2_ckpt ...] [--encoder_ckpt ...] \\
        [--device cpu]

The matcher computes in bf16 on a GPU and in float32 on the CPU. The
images are resized on the device, by the reference's bicubic weights
without antialiasing (`ops/resize.resize`); the JAX package's script
resizes them on the host with the same weights.
"""
import argparse
import json
import os
import random
import statistics

import numpy as np
import torch

from no_time_to_train_tpu_torch.data.coco_api import COCO
from no_time_to_train_tpu_torch.data.image_io import read_rgb
from no_time_to_train_tpu_torch.utils.entry import (compute_dtype,
                                                    entry_device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Few-shot episodic dispersion evaluation")
    p.add_argument("--coco_json", type=str,
                   default="data/olive_diseases/annotations/"
                           "instances_all.json")
    p.add_argument("--img_dir", type=str,
                   default="data/olive_diseases/all_images")
    p.add_argument("--backend", choices=("nttt",), default="nttt")
    p.add_argument("--sam2_cfg", type=str, default="sam2_hiera_l.yaml")
    p.add_argument("--sam2_ckpt", type=str, default=None)
    p.add_argument("--encoder", type=str, default="dinov2_large")
    p.add_argument("--encoder_ckpt", type=str, default=None)
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--shots", type=str, default="1,2,3,5,10")
    p.add_argument("--episodes", type=int, default=1000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out_json", type=str, default="sam3_olive_results.json")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def calculate_iou(pred_mask, gt_mask):
    inter = np.logical_and(pred_mask, gt_mask).sum()
    union = np.logical_or(pred_mask, gt_mask).sum()
    if union == 0:
        return 1.0 if inter == 0 else 0.0
    return inter / union


def load_image_and_gt(coco, img_dir, img_id, cat_id):
    """Image (uint8 RGB [H, W, 3]), binary class GT mask, instance boxes
    (xyxy)."""
    info = coco.loadImgs([img_id])[0]
    image = read_rgb(os.path.join(img_dir, info["file_name"]))
    anns = coco.loadAnns(coco.getAnnIds(imgIds=img_id, catIds=[cat_id]))
    gt = np.zeros((info["height"], info["width"]), np.uint8)
    boxes = []
    for ann in anns:
        gt = np.maximum(gt, coco.annToMask(ann))
        x, y, w, h = ann["bbox"]
        boxes.append([x, y, x + w, y + h])
    return image, gt, boxes


def build_nttt_backend(args):
    """fn(support [(image, gt mask)], query image) -> the query's binary
    class mask. Every episode starts from a bank of zeros of its own."""
    from no_time_to_train_tpu_torch.config.presets import SAM2_PRESETS
    from no_time_to_train_tpu_torch.data.datasets import (
        _resize_mask_bilinear)
    from no_time_to_train_tpu_torch.models.matching import memory_bank as mb
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        MatchingConfig, NoAMGMatcher, finalize_results)
    from no_time_to_train_tpu_torch.ops.resize import resize
    from no_time_to_train_tpu_torch.utils import checkpoint as ckpt_io

    cfg = SAM2_PRESETS[args.sam2_cfg]
    sam2_sd = dino_sd = None
    if args.sam2_ckpt and os.path.exists(args.sam2_ckpt):
        sam2_sd = ckpt_io.load_sam2_torch_checkpoint(args.sam2_ckpt)
    if args.encoder_ckpt and os.path.exists(args.encoder_ckpt):
        dino_sd = ckpt_io.load_dino_checkpoint(args.encoder_ckpt)
    if sam2_sd is None or dino_sd is None:
        print("WARNING: missing checkpoints; running with random weights "
              "(smoke mode)")
    device = entry_device(args.device)
    dt = str(compute_dtype(device)).replace("torch.", "")
    memory_length = max(int(s) for s in args.shots.split(","))
    matcher = NoAMGMatcher(
        cfg, args.encoder, MatchingConfig(compute_dtype=dt),
        n_classes=1, memory_length=memory_length, sam2_state_dict=sam2_sd,
        dino_state_dict=dino_sd, seed=args.seed, device=device)
    enc, m = matcher.enc_cfg, matcher.matching
    s = args.image_size

    def on_device(img, size):
        """uint8 [H, W, 3] -> float [size, size, 3] in [0, 1] on the
        device, bicubic."""
        x = torch.as_tensor(np.asarray(img, np.float32) / 255.0,
                            device=device)
        return resize(x, (size, size), mode="bicubic")

    def run(support, query_img):
        matcher.bank = mb.create(1, memory_length, enc.grid_size ** 2,
                                 enc.feat_dim, m.kmeans_k,
                                 m.n_pca_components, device=device)
        imgs = torch.stack([on_device(img, enc.img_size)
                            for img, _ in support])
        masks = np.stack([_resize_mask_bilinear(gt.astype(np.float32),
                                                (enc.img_size,) * 2)
                          for _, gt in support])
        matcher.fill_memory(imgs, masks, np.zeros(len(support), np.int32))
        matcher.postprocess_memory()
        h, w = query_img.shape[:2]
        fin = finalize_results(matcher.test(on_device(query_img, s)), h, w)
        pred = np.zeros((h, w), bool)
        for i in range(len(fin["scores"])):
            if fin["scores"][i] > 0.5:
                pred |= fin["binary_masks"][i]
        return pred

    return run


def main(argv=None):
    """Returns {"final": {K: {class name: [IoU per episode]}}, "errors":
    [episode errors]}."""
    args = parse_args(argv)
    entry_device(args.device)
    random.seed(args.seed)
    np.random.seed(args.seed)

    print(f"--- Few-shot dispersion evaluator ({args.backend}) ---")
    coco = COCO(args.coco_json)
    cat_ids = coco.getCatIds()
    cat_names = {c["id"]: c["name"] for c in coco.loadCats(cat_ids)}
    shots_list = [int(s) for s in args.shots.split(",")]
    backend = build_nttt_backend(args)

    final = {k: {n: [] for n in cat_names.values()} for k in shots_list}
    errors = []
    for k in shots_list:
        print(f"\n[K={k} shots]")
        for cat_id in cat_ids:
            name = cat_names[cat_id]
            img_ids = list(coco.getImgIds(catIds=[cat_id]))
            if len(img_ids) < k + 1:
                print(f"Skipping {name} (not enough images for {k}-shot)")
                continue
            print(f"  > Class: {name} | Episodes: {args.episodes}")
            for _ in range(args.episodes):
                random.shuffle(img_ids)
                support_ids, query_id = img_ids[:k], img_ids[k]
                try:
                    support = []
                    for sid in support_ids:
                        img, gt, boxes = load_image_and_gt(
                            coco, args.img_dir, sid, cat_id)
                        if len(boxes) > 0:
                            support.append((img, gt))
                    if len(support) < k:
                        continue
                    q_img, q_gt, _ = load_image_and_gt(
                        coco, args.img_dir, query_id, cat_id)
                    pred = backend(support, q_img)
                    final[k][name].append(calculate_iou(pred, q_gt > 0))
                except Exception as e:
                    print(f"    episode error: {type(e).__name__}: {e}")
                    errors.append(f"{type(e).__name__}: {e}")
                    continue

    print("\n\n==========================================")
    print("FINAL RESULTS")
    print("==========================================")
    print(f"{'Shot':<5} | {'Class':<20} | {'Mean IoU':<10} | "
          f"{'Std Dev':<10} | {'95% CI':<10}")
    print("-" * 65)
    for k in shots_list:
        means = []
        for name in cat_names.values():
            scores = final[k][name]
            if not scores:
                continue
            mean = statistics.mean(scores) * 100
            stdev = statistics.stdev(scores) * 100 if len(scores) > 1 else 0.0
            ci = 1.96 * (stdev / np.sqrt(len(scores)))
            means.append(mean)
            print(f"{k:<5} | {name:<20} | {mean:5.2f}      | "
                  f"{stdev:5.2f}      | ±{ci:4.2f}")
        if means:
            print(f"{k:<5} | {'*GLOBAL mIoU*':<20} | "
                  f"{statistics.mean(means):5.2f}      | --          | --")
        print("-" * 65)

    with open(args.out_json, "w") as f:
        json.dump(final, f)
    print(f"Saved full raw data to {args.out_json}")
    return {"final": final, "errors": errors}


if __name__ == "__main__":
    main()
