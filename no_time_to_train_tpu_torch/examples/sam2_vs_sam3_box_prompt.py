"""SAM2 with a single bounding-box prompt: the SAM2 side of the reference
notebook `notebooks/sam2 vs sam3.ipynb` (port of
`examples/sam2_vs_sam3_box_prompt.py`'s `run_sam2`).

One box around the left cat of cats.jpg: SAM2 (an instance model) should
segment only the prompted cat. The box goes to the port's
`SAM2ImagePredictor` with `multimask_output=True` and the mask of the
highest predicted IoU is kept, as the notebook picks it. The SAM3 side
(HuggingFace's Sam3Model) stays in the JAX-side example: it runs no code of
this system.

    python -m no_time_to_train_tpu_torch.examples.sam2_vs_sam3_box_prompt \\
        --image cats.png --box 10 20 300 500 \\
        --sam2-ckpt checkpoints/sam2_hiera_large.pt --out sam2_box.png \\
        [--device cpu]

Writes two panels side by side, the box prompt and SAM2's mask (blue,
alpha 0.45) under the box (yellow), drawn by `data/visualization.py`.
"""
import argparse

import numpy as np

from no_time_to_train_tpu_torch.config.presets import SAM2_PRESETS
from no_time_to_train_tpu_torch.data.image_io import read_rgb, save_png
from no_time_to_train_tpu_torch.data.visualization import (draw_rectangle,
                                                           draw_text)
from no_time_to_train_tpu_torch.models.sam2.image_predictor import (
    SAM2ImagePredictor)
from no_time_to_train_tpu_torch.utils.entry import (build_sam2,
                                                    compute_dtype,
                                                    entry_device)

BOX_COLOR, MASK_COLOR, MASK_ALPHA = (255, 255, 0), (26, 128, 255), 0.45


def run_sam2(image, box, sam2_cfg, sam2_ckpt, *, device):
    """image uint8 [H, W, 3], box XYXY in its pixels -> (the mask of the
    highest predicted IoU [H, W] bool, that IoU). Without the checkpoint
    file the weights are drawn from seed 0."""
    model = build_sam2(SAM2_PRESETS[sam2_cfg], sam2_ckpt, device=device,
                       dtype=compute_dtype(device))
    pred = SAM2ImagePredictor(model)
    pred.set_image(np.asarray(image, np.float32) / 255.0)
    masks, ious, _ = pred.predict(box=np.asarray(box, np.float32),
                                  multimask_output=True)
    best = int(np.argmax(ious[0]))
    return masks[0, best], float(ious[0, best])


def panel(image, box, title, mask=None):
    out = np.asarray(image, np.float32)
    if mask is not None:
        out[mask] = out[mask] * (1 - MASK_ALPHA) + \
            np.asarray(MASK_COLOR, np.float32) * MASK_ALPHA
    out = out.clip(0, 255).astype(np.uint8)
    draw_rectangle(out, box, BOX_COLOR, width=2)
    draw_text(out, (2, 2), title, (255, 255, 255))
    return out


def main(argv=None):
    """Returns (the mask, its predicted IoU, the written path)."""
    p = argparse.ArgumentParser()
    p.add_argument("--image", required=True)
    p.add_argument("--box", type=float, nargs=4, required=True,
                   metavar=("X1", "Y1", "X2", "Y2"))
    p.add_argument("--sam2-cfg", default="sam2_hiera_l.yaml")
    p.add_argument("--sam2-ckpt", default=None)
    p.add_argument("--out", default="sam2_box_prompt.png")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    device = entry_device(a.device)
    image = read_rgb(a.image)
    mask, iou = run_sam2(image, a.box, a.sam2_cfg, a.sam2_ckpt,
                         device=device)
    h, w = image.shape[:2]
    canvas = np.full((h, 2 * w + 5, 3), 255, np.uint8)
    canvas[:, :w] = panel(image, a.box, "box prompt")
    canvas[:, w + 5:] = panel(image, a.box, f"SAM2 (iou {iou:.2f})", mask)
    save_png(a.out, canvas)
    print(f"wrote {a.out} (SAM2 panel only)")
    return mask, iou, a.out


if __name__ == "__main__":
    main()
