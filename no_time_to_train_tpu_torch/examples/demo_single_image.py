"""Single-image demo (port of `examples/demo_single_image.py`; BASELINE
config 1's shape: Hiera-T, 1-shot, one reference mask, one query image —
e.g. the reference's notebooks/cats.jpg).

    python -m no_time_to_train_tpu_torch.examples.demo_single_image \\
        --ref-image cat1.png --ref-mask cat1_mask.png \\
        --query-image cats.png --sam2-ckpt checkpoints/sam2_hiera_tiny.pt \\
        --out overlay.png [--device cpu]

Without checkpoints the weights are drawn from seed 0. The matcher
computes in bf16 on a GPU and in float32 on the CPU. The overlay is written
as a PNG.
"""
import argparse

import numpy as np

from no_time_to_train_tpu_torch.config.presets import SAM2_PRESETS
from no_time_to_train_tpu_torch.data.datasets import load_image
from no_time_to_train_tpu_torch.data.image_io import (read_gray, read_rgb,
                                                      save_png)
from no_time_to_train_tpu_torch.data.visualization import _overlay_masks
from no_time_to_train_tpu_torch.models.matching.pipeline import (
    MatchingConfig, NoAMGMatcher, finalize_results)
from no_time_to_train_tpu_torch.utils.checkpoint import (
    load_dino_checkpoint, load_sam2_torch_checkpoint)
from no_time_to_train_tpu_torch.utils.entry import (compute_dtype,
                                                    entry_device)


def main(argv=None):
    """Returns (finalize_results of the query, the overlay's path)."""
    p = argparse.ArgumentParser()
    p.add_argument("--ref-image", required=True)
    p.add_argument("--ref-mask", required=True)
    p.add_argument("--query-image", required=True)
    p.add_argument("--sam2-cfg", default="sam2_hiera_t.yaml")
    p.add_argument("--sam2-ckpt", default=None)
    p.add_argument("--encoder", default="dinov2_small")
    p.add_argument("--encoder-ckpt", default=None)
    p.add_argument("--out", default="demo_out.png")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    device = entry_device(a.device)
    sam2_sd = load_sam2_torch_checkpoint(a.sam2_ckpt) if a.sam2_ckpt \
        else None
    dino_sd = load_dino_checkpoint(a.encoder_ckpt) if a.encoder_ckpt \
        else None
    dt = str(compute_dtype(device)).replace("torch.", "")
    matcher = NoAMGMatcher(a.sam2_cfg, a.encoder,
                           MatchingConfig(compute_dtype=dt), n_classes=1,
                           memory_length=1, sam2_state_dict=sam2_sd,
                           dino_state_dict=dino_sd, device=device)

    ref_img, _, _ = load_image(a.ref_image, image_size=518)
    mask = read_gray(a.ref_mask).astype(np.float32) / 255.0
    matcher.fill_memory(ref_img[None], mask[None], [0])
    matcher.postprocess_memory()

    cfg = SAM2_PRESETS[a.sam2_cfg]
    query, oh, ow = load_image(a.query_image, image_size=cfg.image_size)
    fin = finalize_results(matcher.test(query), oh, ow)
    print(f"{len(fin['scores'])} detections; top scores: "
          f"{np.round(fin['scores'][:5], 3)}")

    out = _overlay_masks(read_rgb(a.query_image), fin["binary_masks"],
                         fin["labels"])
    save_png(a.out, out)
    print(f"overlay -> {a.out}")
    return fin, a.out


if __name__ == "__main__":
    main()
