"""Mask utilities (port of `no_time_to_train_tpu/ops/masks.py`; reference
sam2/utils/amg.py)."""
import torch

__all__ = ["batched_mask_to_box", "stability_score", "mask_iou_matrix"]


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


def stability_score(mask_logits, mask_threshold=0.0, threshold_offset=1.0):
    """IoU of the masks thresholded above and below `mask_threshold` by
    `threshold_offset` (reference amg.py:158-178), float32 [...]."""
    inter = (mask_logits > (mask_threshold + threshold_offset)).sum((-1, -2))
    union = (mask_logits > (mask_threshold - threshold_offset)).sum((-1, -2))
    return inter.float() / union.float()


def mask_iou_matrix(masks_a, masks_b):
    """Pairwise IoU [N, M] of boolean stacks [N, H, W] and [M, H, W] by one
    matrix product; 0 where both masks are empty."""
    a = masks_a.reshape(masks_a.shape[0], -1).float()
    b = masks_b.reshape(masks_b.shape[0], -1).float()
    inter = a @ b.T
    union = a.sum(-1, keepdim=True) + b.sum(-1, keepdim=True).T - inter
    return torch.where(union > 0, inter / union.clamp(min=1.0),
                       torch.zeros_like(inter))
