"""Mask utilities (port of `no_time_to_train_tpu/ops/masks.py`)."""
import torch

__all__ = ["batched_mask_to_box"]


def batched_mask_to_box(masks):
    """XYXY boxes around boolean masks [..., H, W] -> [..., 4] int64; empty
    masks give [0, 0, 0, 0] (reference sam2/utils/amg.py:305-347)."""
    h, w = masks.shape[-2], masks.shape[-1]
    masks = masks.bool()
    in_height = masks.any(dim=-1)
    hc = in_height * torch.arange(h, device=masks.device)
    bottom = hc.amax(dim=-1)
    top = (hc + h * (~in_height)).amin(dim=-1)
    in_width = masks.any(dim=-2)
    wc = in_width * torch.arange(w, device=masks.device)
    right = wc.amax(dim=-1)
    left = (wc + w * (~in_width)).amin(dim=-1)
    empty = (right < left) | (bottom < top)
    box = torch.stack([left, top, right, bottom], dim=-1)
    return box * (~empty)[..., None]
