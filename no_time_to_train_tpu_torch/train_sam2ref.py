"""Train the SAM2Ref custom-IoU head (port of `scripts/train_sam2ref.py`;
the reference's legacy `fit` path, pl_wrapper/sam2ref_pl.py): frozen SAM2,
AdamW with a no-decay split, linear warm-up + multi-step decay, lr scaled by
the total batch size; L1 IoU regression against the matched oracle IoU.

    python -m no_time_to_train_tpu_torch.train_sam2ref --root imgs/ \\
        --json-file ann.json [--sam2-ckpt sam2_hiera_large.pt] \\
        [--steps 1000] [--out work_dirs/sam2ref_head.pkl] [--device cpu]

Without `--sam2-ckpt` SAM2 takes seeded random weights. `--device` defaults
to `cuda`; without a CUDA device only `--device cpu` runs. The head is
written as the JAX package's trainer writes it: a pickle of the JAX head
tree with numpy leaves, so a head trained by either package loads into the
other.
"""
import argparse
import dataclasses
import os
import pickle

import numpy as np
import torch

from no_time_to_train_tpu_torch.config.presets import SAM2_PRESETS
from no_time_to_train_tpu_torch.data.datasets import COCORefTrainDataset
from no_time_to_train_tpu_torch.models.sam2.model import SAM2
from no_time_to_train_tpu_torch.models.sam2ref import SAM2Ref, Sam2RefConfig
from no_time_to_train_tpu_torch.ops.resize import _resize_matrix_np
from no_time_to_train_tpu_torch.utils.checkpoint import (
    load_sam2_torch_checkpoint)
from no_time_to_train_tpu_torch.utils.convert import (
    sam2ref_heads_params, sam2ref_heads_state_dict)
from no_time_to_train_tpu_torch.utils.init import init_random_

__all__ = ["make_batch", "build_sam2", "save_head", "load_head", "main"]


def make_batch(ds, idxs, n_cat_max, n_refs, n_points, n_ins_max, image_size,
               device="cpu"):
    """Collate dataset items into the fixed-shape training batch, as tensors
    on `device`; the GT masks are downsampled to S/4 on the device by the
    bilinear resize matrix of the JAX package's collate."""
    g = len(idxs) * n_cat_max
    s = image_size
    tar = np.zeros((g, s, s, 3), np.float32)
    refs = np.zeros((g, n_refs, s, s, 3), np.float32)
    rmask = np.zeros((g, n_refs, s, s), np.float32)
    qpts = np.zeros((g, n_points, 2), np.float32)
    gt_full = np.zeros((g, n_ins_max, s, s), np.float32)
    gt_valid = np.zeros((g, n_ins_max), bool)
    cat_valid = np.zeros((g,), bool)

    for bi, idx in enumerate(idxs):
        item = ds[int(idx)]
        cats = list(item["refs_by_cat"].keys())[:n_cat_max]
        for ci, cat in enumerate(cats):
            gslot = bi * n_cat_max + ci
            tar[gslot] = item["target_img"]
            r = item["refs_by_cat"][cat]
            n = min(n_refs, len(r["imgs"]))
            refs[gslot, :n] = r["imgs"][:n]
            rmask[gslot, :n] = r["masks"][:n]
            anns = item["tar_anns_by_cat"][cat]
            pts = anns["query_points"][:n_points]
            qpts[gslot, :len(pts)] = pts
            masks = anns["masks"][:n_ins_max]
            gt_full[gslot, :len(masks)] = masks
            gt_valid[gslot, :len(masks)] = True
            cat_valid[gslot] = True

    def dev(x):
        return torch.as_tensor(x, device=device)

    wh = dev(_resize_matrix_np(s, s // 4, "bilinear", True).astype(
        np.float32))
    gt = (wh @ dev(gt_full) @ wh.T) > 0
    return dict(tar_imgs=dev(tar), ref_imgs=dev(refs), ref_masks=dev(rmask),
                query_points=dev(qpts), gt_masks=gt, gt_valid=dev(gt_valid),
                cat_valid=dev(cat_valid))


def build_sam2(cfg, ckpt=None, seed=0):
    """The port's SAM2 on the CPU: a reference checkpoint's weights, or
    seeded random ones."""
    model = SAM2(cfg)
    if ckpt:
        model.load_state_dict(load_sam2_torch_checkpoint(ckpt), strict=True)
    else:
        init_random_(model, torch.Generator().manual_seed(seed))
    return model


def save_head(ref, path):
    """Write the heads as the JAX head tree with numpy leaves."""
    with open(path, "wb") as f:
        pickle.dump(sam2ref_heads_params(ref.heads.state_dict()), f)


def load_head(ref, path):
    """Load a head pickle written by either package's trainer."""
    with open(path, "rb") as f:
        tree = pickle.load(f)
    ref.heads.load_state_dict(
        {k: torch.as_tensor(v) for k, v in
         sam2ref_heads_state_dict(tree).items()}, strict=True)


def main(argv=None):
    """Returns {"losses": the loss of each step (float32 array), "out": the
    path of the head written}."""
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--json-file", required=True)
    p.add_argument("--sam2-cfg", default="sam2_hiera_l.yaml")
    p.add_argument("--sam2-ckpt", default=None)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--base-lr", type=float, default=1e-4)
    p.add_argument("--warmup-iters", type=int, default=250)
    p.add_argument("--n-points", type=int, default=8)
    p.add_argument("--out", default="work_dirs/sam2ref_head.pkl")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)

    cfg = SAM2_PRESETS[a.sam2_cfg]
    if a.image_size:
        cfg = dataclasses.replace(cfg, image_size=a.image_size)
    ref = SAM2Ref(build_sam2(cfg, a.sam2_ckpt, a.seed), Sam2RefConfig(),
                  device=a.device, seed=a.seed)

    ds = COCORefTrainDataset(a.root, a.json_file, cfg.image_size,
                             n_pos_points=a.n_points // 2, neg_ratio=1.0,
                             seed=a.seed)
    opt, sched = ref.make_optimizer(
        base_lr=a.base_lr, warmup_iters=a.warmup_iters,
        decay_steps=(int(a.steps * 0.8),), train_bs=a.batch_size)
    step_fn = ref.make_train_step(opt, sched)

    rng = np.random.default_rng(a.seed)
    losses = []
    for step in range(a.steps):
        idxs = rng.integers(0, len(ds), a.batch_size)
        batch = make_batch(ds, idxs, n_cat_max=1, n_refs=1,
                           n_points=a.n_points, n_ins_max=8,
                           image_size=cfg.image_size, device=ref.device)
        loss, metrics = step_fn(batch)
        losses.append(loss)
        if step % 20 == 0:
            print(f"step {step}: iou_loss {float(loss):.4f} "
                  f"mean_seg_iou {float(metrics['mean_seg_iou']):.4f}")

    out_dir = os.path.dirname(a.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    save_head(ref, a.out)
    print(f"trained head -> {a.out}")

    return dict(losses=torch.stack(losses).float().cpu().numpy(),
                out=a.out)


if __name__ == "__main__":
    main()
