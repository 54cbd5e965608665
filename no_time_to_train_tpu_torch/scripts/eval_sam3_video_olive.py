"""Few-shot-as-video comparison harness, the `sam2_video` backend (port of
`scripts/eval_sam3_video_olive.py`, itself after the reference's
scripts/eval_sam3_video_olive.py:1-426).

Frames K-shot segmentation as a video problem: the K support crops are
prompted frames (GT masks as prompts, one object id per class), the query
image is the last frame; propagate and read the last frame's masks. The
backend is the port's SAM2 video predictor (`models/sam2/video.py`). The
reference's `sam3` backend (HuggingFace's SAM3 tracker) stays in the
JAX-side script: it runs no code of this system.

    python -m no_time_to_train_tpu_torch.scripts.eval_sam3_video_olive \\
        --data_root data/olive_diseases --class_split olive_diseases \\
        [--shots 10] [--sam2_ckpt ...] [--evaluate_coco] [--device cpu]

Writes <output_dir>/<prediction_file> (COCO records) and
<output_dir>/sam3_runtime.json in the schema that
scripts/aggregate_nttt_sam3_metrics.py reads. The two resizes that the
reference makes with OpenCV are `image_io.resize_linear_cv2` and
`resize_nearest_cv2`, equal to cv2's bit for bit.
"""
import argparse
import dataclasses
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

from no_time_to_train_tpu_torch.config.presets import SAM2_PRESETS
from no_time_to_train_tpu_torch.data import rle as rle_mod
from no_time_to_train_tpu_torch.data.datasets import (
    COCOMemoryFillCropDataset, COCORefOracleTestDataset)
from no_time_to_train_tpu_torch.data.few_shot_sampling import (
    sample_memory_dataset)
from no_time_to_train_tpu_torch.data.image_io import (resize_linear_cv2,
                                                      resize_nearest_cv2)
from no_time_to_train_tpu_torch.models.sam2.video import SAM2VideoPredictor
from no_time_to_train_tpu_torch.utils.entry import (build_sam2,
                                                    compute_dtype,
                                                    entry_device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="SAM2 video-based few-shot evaluation")
    p.add_argument("--shots", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--backend", choices=("sam2_video",), default="sam2_video")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--data_root", type=str, default="data/olive_diseases")
    p.add_argument("--class_split", type=str, default="olive_diseases")
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--sam2_cfg", type=str, default="sam2_hiera_l.yaml")
    p.add_argument("--sam2_ckpt", type=str, default=None)
    p.add_argument("--output_dir", type=str,
                   default="work_dirs/sam3_video_results")
    p.add_argument("--prediction_file", type=str,
                   default="sam3_predictions.json")
    p.add_argument("--score", type=float, default=None,
                   help="constant confidence override; default derives the "
                        "score from mask logits")
    p.add_argument("--evaluate_coco", action="store_true")
    p.add_argument("--max_queries", type=int, default=None)
    return p.parse_args(argv)


def calculate_iou(pred_mask, gt_mask):
    inter = np.logical_and(pred_mask, gt_mask).sum()
    union = np.logical_or(pred_mask, gt_mask).sum()
    if union == 0:
        return 1.0 if inter == 0 else 0.0
    return inter / union


def mask_to_bbox_xywh(mask):
    ys, xs = np.where(mask > 0)
    if len(xs) == 0:
        return None
    return [float(xs.min()), float(ys.min()),
            float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)]


def build_sam2_video_backend(args):
    """The port's video predictor: returns fn(frames [T, S, S, 3],
    masks_by_obj {obj_id: [(frame_idx, mask)]}) -> (logits [n_obj, S/4,
    S/4] float32 numpy, obj order)."""
    cfg = SAM2_PRESETS[args.sam2_cfg] if isinstance(args.sam2_cfg, str) \
        else args.sam2_cfg
    if cfg.image_size != args.image_size:
        cfg = dataclasses.replace(cfg, image_size=args.image_size)
    if not (args.sam2_ckpt and os.path.exists(args.sam2_ckpt)):
        print("WARNING: no --sam2_ckpt; running with random weights "
              "(smoke mode)")
    device = torch.device(args.device)
    model = build_sam2(cfg, args.sam2_ckpt, device=device,
                       dtype=compute_dtype(device), seed=args.seed)
    pred = SAM2VideoPredictor(model, device=device)

    def run(frames, masks_by_obj):
        state = pred.init_state(frames)
        for obj_id, prompts in masks_by_obj.items():
            for frame_idx, mask in prompts:
                pred.add_new_mask(state, frame_idx, obj_id, mask)
        last = len(frames) - 1
        logits = None
        for frame_idx, _, masks in pred.propagate_in_video(state):
            if frame_idx == last:
                logits = masks.float().cpu().numpy()
        return logits, list(state["obj_id_to_idx"].keys())

    return run


def main(argv=None):
    """Returns {"predictions", "runtime", "miou": {cat_id: mean IoU},
    "stats": {iou_type: COCOeval stats}}."""
    args = parse_args(argv)
    device = entry_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    np.random.seed(args.seed)

    support_pkl = os.path.join(
        "work_dirs/olive_results",
        f"olive_{args.shots}shot_seed{args.seed}.pkl")
    train_json = os.path.join(args.data_root,
                              "annotations/instances_train2017.json")
    if not os.path.exists(support_pkl):
        print(f"Generating few-shot split at {support_pkl}...")
        os.makedirs(os.path.dirname(support_pkl), exist_ok=True)
        sample_memory_dataset(json_file=train_json, out_path=support_pkl,
                              memory_length=args.shots, remove_bad=True,
                              dataset=args.class_split)

    support_set = COCOMemoryFillCropDataset(
        root=os.path.join(args.data_root, "train2017"),
        json_file=train_json, memory_pkl=support_pkl,
        class_split=args.class_split, image_size=args.image_size,
        memory_length=args.shots, context_ratio=0.2, norm_img=False)
    query_set = COCORefOracleTestDataset(
        root=os.path.join(args.data_root, "val2017"),
        json_file=os.path.join(args.data_root,
                               "annotations/instances_val2017.json"),
        image_size=args.image_size, norm_img=False,
        class_split=args.class_split, with_query_points=False)
    print(f"Support Set: {len(support_set)} items")
    print(f"Query Set: {len(query_set)} items")

    supports = [support_set[i] for i in range(len(support_set))]
    support_frames = np.stack([it["img"] for it in supports])
    masks_by_obj = defaultdict(list)
    for i, it in enumerate(supports):
        masks_by_obj[int(it["cat_ind"]) + 1].append((i, it["mask"] > 0.5))
    max_cat = max(int(it["cat_ind"]) for it in supports)

    backend = build_sam2_video_backend(args)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    results = defaultdict(list)
    predictions = []
    total_t = 0.0
    n_queries = len(query_set) if args.max_queries is None \
        else min(args.max_queries, len(query_set))
    for qi in range(n_queries):
        t0 = time.perf_counter()
        q = query_set[qi]
        frames = np.concatenate([support_frames, q["target_img"][None]])
        logits, obj_order = backend(frames, masks_by_obj)
        if logits is None:
            continue
        s = args.image_size
        gt_anns = q.get("tar_anns_by_cat", {})
        info = q["target_img_info"]
        ori_h, ori_w = int(info["ori_height"]), int(info["ori_width"])
        for cat_ind in range(max_cat + 1):
            obj_id = cat_ind + 1
            if obj_id in obj_order:
                logit = logits[obj_order.index(obj_id)]
            else:
                logit = np.full((s // 4, s // 4), -32.0, np.float32)
            # upsample low-res logits to model res, binarize
            logit_up = resize_linear_cv2(logit, (s, s))
            pred_mask = logit_up > 0
            if cat_ind in gt_anns:
                gm = np.asarray(gt_anns[cat_ind]["masks"])
                gt_mask = (gm.sum(0) if gm.ndim == 3 else gm) > 0.5
            else:
                gt_mask = np.zeros_like(pred_mask)
            iou = calculate_iou(pred_mask, gt_mask)
            real_cat_id = support_set.cat_inds_to_ids[cat_ind]
            results[real_cat_id].append(iou)

            if pred_mask.sum() == 0:
                continue
            pred_resized = resize_nearest_cv2(pred_mask.astype(np.uint8),
                                              (ori_h, ori_w))
            if pred_resized.sum() == 0:
                continue
            bbox = mask_to_bbox_xywh(pred_resized)
            if bbox is None:
                continue
            if args.score is not None:
                score = float(args.score)
            else:
                prob = 1.0 / (1.0 + np.exp(-np.clip(logit_up, -30, 30)))
                score = float(prob[pred_mask].mean())
            predictions.append({
                "image_id": int(info["id"]),
                "category_id": int(real_cat_id),
                "bbox": bbox, "score": score,
                "segmentation": rle_mod.encode_mask(pred_resized),
            })
        total_t += time.perf_counter() - t0
        if (qi + 1) % 10 == 0:
            print(f"query {qi + 1}/{n_queries}")

    print("\n--- Evaluation Results ---")
    print(f"{'Class ID':<10} | {'Class Name':<20} | {'mIoU':<10}")
    print("-" * 46)
    all_ious, miou_by_cat = [], {}
    cats_info = support_set.coco.cats
    for cat_id, ious in results.items():
        miou = sum(ious) / len(ious)
        all_ious.append(miou)
        miou_by_cat[cat_id] = float(miou)
        name = cats_info[cat_id]["name"] if cat_id in cats_info \
            else str(cat_id)
        print(f"{cat_id:<10} | {name:<20} | {miou:.4f}")
    print("-" * 46)
    overall = sum(all_ious) / len(all_ious) if all_ious else 0.0
    print(f"Overall mIoU: {overall:.4f}")

    pred_path = os.path.join(args.output_dir, args.prediction_file)
    with open(pred_path, "w") as f:
        json.dump(predictions, f)
    print(f"Saved {len(predictions)} predictions to {pred_path}")

    fps = n_queries / total_t if total_t > 0 else 0.0
    runtime = {"model": args.backend, "shots": int(args.shots),
               "seed": int(args.seed), "num_queries": int(n_queries),
               "total_inference_time_sec": float(total_t),
               "fps": float(fps), "peak_vram_mib": None}
    if device.type == "cuda":
        runtime["peak_vram_mib"] = float(
            torch.cuda.max_memory_allocated(device) / 2 ** 20)
    with open(os.path.join(args.output_dir, "sam3_runtime.json"), "w") as f:
        json.dump(runtime, f, indent=2)
    print(f"{args.backend} FPS: {fps:.3f}")

    stats = {}
    if args.evaluate_coco and predictions:
        from no_time_to_train_tpu_torch.data.cocoeval import COCOeval
        coco_results = query_set.coco.loadRes(predictions)
        for iou_type in ("bbox", "segm"):
            ev = COCOeval(query_set.coco, coco_results, iou_type)
            ev.params.imgIds = query_set.img_ids
            ev.evaluate()
            ev.accumulate()
            ev.summarize()
            stats[iou_type] = ev.stats
    return {"predictions": predictions, "runtime": runtime,
            "miou": miou_by_cat, "stats": stats}


if __name__ == "__main__":
    main()
