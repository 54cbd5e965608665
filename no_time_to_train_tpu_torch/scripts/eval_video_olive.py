"""Few-shot segmentation via video propagation (port of
`scripts/eval_video_olive.py`, itself after the reference's
scripts/eval_sam3_video_olive.py:181-249 on SAM2's video predictor): the
supports are prompted frames of a pseudo-video, the query image is its last
frame; the masks propagate through SAM2's memory attention and the last
frame's predictions are evaluated COCO-style.

    python -m no_time_to_train_tpu_torch.scripts.eval_video_olive \\
        --test-json val.json --test-root val/ --memory-pkl refs.pkl \\
        --train-json train.json --train-root train/ [--n-shot 3] \\
        [--sam2-ckpt checkpoints/sam2_hiera_large.pt] [--device cpu]

Without the checkpoint file the weights are drawn from seed 0. The model
runs in bf16 on a GPU and in float32 on the CPU.
"""
import argparse
import json
import os
import pickle

import numpy as np
import torch

from no_time_to_train_tpu_torch.config.presets import SAM2_PRESETS
from no_time_to_train_tpu_torch.data import rle as rle_mod
from no_time_to_train_tpu_torch.data.coco_api import COCO
from no_time_to_train_tpu_torch.data.cocoeval import COCOeval
from no_time_to_train_tpu_torch.data.datasets import (_resize_mask_nearest,
                                                      load_image)
from no_time_to_train_tpu_torch.models.sam2.video import SAM2VideoPredictor
from no_time_to_train_tpu_torch.ops.resize import resize_hw
from no_time_to_train_tpu_torch.utils.entry import (build_sam2,
                                                    compute_dtype,
                                                    entry_device)
from no_time_to_train_tpu_torch.utils.profiling import (Timer,
                                                        device_memory_stats)


def build_predictor(sam2_cfg="sam2_hiera_l.yaml", ckpt=None, *, device):
    """The port's video predictor on `device` in its compute dtype: the
    checkpoint's weights where the file exists, else weights drawn from
    seed 0."""
    model = build_sam2(SAM2_PRESETS[sam2_cfg], ckpt, device=device,
                       dtype=compute_dtype(device))
    return SAM2VideoPredictor(model, device=device)


def propagate_one_query(pred, support_imgs, support_masks, query_img):
    """supports + query as a pseudo-video, one object per support frame;
    returns the last frame's low-res logits [n_obj, S/4, S/4] on the device
    (reference :181-249)."""
    frames = np.stack(list(support_imgs) + [query_img])
    state = pred.init_state(frames)
    for t, mask in enumerate(support_masks):
        pred.add_new_mask(state, t, obj_id=t + 1, mask=mask)
    last = len(frames) - 1
    out = None
    for fidx, _, logits in pred.propagate_in_video(state):
        if fidx == last:
            out = logits
    return out


def query_records(logits, img_id, cat_id, ori_hw):
    """COCO records of one query's last-frame logits: each object
    upsampled bilinearly to the original size and thresholded at 0, scored
    by the sigmoid of its largest logit; empty masks are dropped."""
    up = (resize_hw(logits.float(), ori_hw, mode="bilinear") > 0).cpu().numpy()
    peaks = logits.float().amax(dim=(-2, -1)).cpu().numpy()
    records = []
    for mask, peak in zip(up, peaks):
        if not mask.any():
            continue
        ys, xs = np.nonzero(mask)
        records.append({
            "image_id": img_id, "category_id": int(cat_id),
            "score": float(1.0 / (1.0 + np.exp(-float(peak)))),
            "bbox": [float(xs.min()), float(ys.min()),
                     float(xs.max() - xs.min()), float(ys.max() - ys.min())],
            "segmentation": rle_mod.encode_mask(mask)})
    return records


def load_supports(train_json, train_root, memory, n_shot, size):
    """{cat_id: (images, masks)}: the first n_shot references of each
    class at the model's square size."""
    train = COCO(train_json)
    supports = {}
    for cat_id, refs in memory.items():
        imgs, masks = [], []
        for d in refs[:n_shot]:
            info = train.loadImgs([d["img_id"]])[0]
            img, _, _ = load_image(os.path.join(train_root,
                                                info["file_name"]),
                                   image_size=size)
            ann = train.loadAnns(d["ann_ids"])[0]
            imgs.append(img)
            masks.append(_resize_mask_nearest(
                train.annToMask(ann).astype(np.float32), (size, size)))
        supports[cat_id] = (imgs, masks)
    return supports


def main(argv=None):
    """Returns {"results": the COCO records, "seconds": per test image,
    "stats": {iou_type: COCOeval stats}}."""
    p = argparse.ArgumentParser()
    p.add_argument("--test-json", required=True)
    p.add_argument("--test-root", required=True)
    p.add_argument("--memory-pkl", required=True)
    p.add_argument("--train-json", required=True)
    p.add_argument("--train-root", required=True)
    p.add_argument("--sam2-cfg", default="sam2_hiera_l.yaml")
    p.add_argument("--sam2-ckpt", default="./checkpoints/sam2_hiera_large.pt")
    p.add_argument("--n-shot", type=int, default=3)
    p.add_argument("--out-json", default="video_olive_results.json")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    device = entry_device(a.device)
    pred = build_predictor(a.sam2_cfg, a.sam2_ckpt, device=device)
    s = pred.cfg.image_size
    with open(a.memory_pkl, "rb") as f:
        memory = pickle.load(f)
    supports = load_supports(a.train_json, a.train_root, memory, a.n_shot, s)

    test = COCO(a.test_json)
    img_ids = sorted(test.imgs.keys())
    if a.max_images:
        img_ids = img_ids[: a.max_images]

    sync = torch.cuda.synchronize if device.type == "cuda" else None
    timer = Timer()
    results = []
    for n, img_id in enumerate(img_ids):
        info = test.loadImgs([img_id])[0]
        query, oh, ow = load_image(os.path.join(a.test_root,
                                                info["file_name"]),
                                   image_size=s)
        with timer.step(sync=sync):
            for cat_id, (simgs, smasks) in supports.items():
                logits = propagate_one_query(pred, simgs, smasks, query)
                results += query_records(logits, img_id, cat_id, (oh, ow))
        if (n + 1) % 10 == 0:
            print(f"{n + 1}/{len(img_ids)}", device_memory_stats(device))

    timer.report()
    with open(a.out_json, "w") as f:
        json.dump(results, f)
    stats = {}
    if results:
        res = test.loadRes(results)
        for iou_type in ("bbox", "segm"):
            ev = COCOeval(test, res, iou_type)
            ev.evaluate()
            ev.accumulate()
            ev.summarize()
            stats[iou_type] = ev.stats
    return {"results": results, "seconds": list(timer.times),
            "stats": stats}


if __name__ == "__main__":
    main()
