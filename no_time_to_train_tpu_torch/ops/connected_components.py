"""Connected components (8-connectivity) and hole filling (port of
`no_time_to_train_tpu/ops/connected_components.py`; the reference's
union-find kernel sam2/csrc/connected_components.cu, used by
fill_holes_in_mask_scores, sam2/utils/misc.py).

Labels spread by iterated 8-neighbourhood minima over the linear pixel
index, restricted to the foreground, as in the JAX package.
`connected_components` runs to the fixed point and asks the device whether
it has converged only after 16, 32, 64, ... steps. `fill_holes_in_mask_scores`
never asks: a component of at most `max_area` pixels converges within
`max_area` steps, and a label region that borders no other label is a whole
component, so `max_area` steps decide every small hole exactly.
"""
import torch
import torch.nn.functional as F

__all__ = ["connected_components", "fill_holes_in_mask_scores",
           "postprocess_masks_cc"]


def _spread(lab, mask, big, steps):
    """`steps` rounds of the foreground-restricted 3x3 minimum; lab
    [N, 1, H, W] float32 (pixel indices are exact there), `big` off the
    foreground and past the border."""
    for _ in range(steps):
        lab = torch.where(mask, -F.max_pool2d(-lab, 3, 1, 1), big)
    return lab


def _seed(mask):
    n, h, w = mask.shape
    big = torch.full((), float(h * w + 1), device=mask.device)
    idx = torch.arange(h * w, dtype=torch.float32, device=mask.device)
    mask = mask[:, None]
    return torch.where(mask, idx.reshape(1, 1, h, w), big), mask, big


def _counts(lab, weight):
    """Per pixel, the sum of `weight` over the pixels that share its label
    (within one image); lab [N, 1, H, W] holds values in [0, H * W + 1]."""
    n, _, h, w = lab.shape
    size = h * w + 2
    offs = torch.arange(n, device=lab.device).reshape(n, 1, 1, 1) * size
    flat = (lab.long() + offs).reshape(-1)
    sums = torch.zeros(n * size, dtype=torch.float32, device=lab.device)
    sums.index_add_(0, flat, weight.reshape(-1).float())
    return sums[flat].reshape(lab.shape)


def connected_components(mask, steps_per_round=16):
    """mask [..., H, W] bool -> (labels int32: 1 + the least linear index of
    the pixel's component, 0 on the background; areas int32: the component's
    pixel count at each foreground pixel, 0 on the background)."""
    shape = mask.shape
    lab, m, big = _seed(mask.reshape((-1,) + shape[-2:]))
    steps = steps_per_round
    while True:
        new = _spread(lab, m, big, steps)
        done = torch.equal(new, lab)
        lab = new
        if done:
            break
        steps *= 2
    areas = torch.where(m, _counts(lab, m), torch.zeros_like(lab))
    labels = torch.where(m, lab + 1, torch.zeros_like(lab))
    return (labels.to(torch.int32).reshape(shape),
            areas.to(torch.int32).reshape(shape))


def fill_holes_in_mask_scores(mask_scores, max_area):
    """Background components (scores <= 0) of at most `max_area` pixels are
    raised to +0.1 (reference sam2/utils/misc.py:254-280). mask_scores
    [..., H, W]; no host synchronisation."""
    if max_area <= 0:
        return mask_scores
    shape = mask_scores.shape
    scores = mask_scores.reshape((-1,) + shape[-2:])
    lab, m, big = _seed(scores <= 0)
    lab = _spread(lab, m, big, int(max_area))
    # a pixel is open when a foreground neighbour holds another label: its
    # label region is then only a part of a larger component
    lo = -F.max_pool2d(-lab, 3, 1, 1)
    hi = F.max_pool2d(torch.where(m, lab, -torch.ones_like(lab)), 3, 1, 1)
    is_open = m & ((lo != lab) | (hi != lab))
    area = _counts(lab, m)
    n_open = _counts(lab, is_open)
    is_hole = (m & (area <= max_area) & (n_open == 0))[:, 0]
    return torch.where(is_hole, torch.full_like(scores, 0.1),
                       scores).reshape(shape)


def postprocess_masks_cc(masks, mask_threshold=0.0, max_hole_area=0.0,
                         max_sprinkle_area=0.0):
    """The hole and sprinkle removal of the reference's
    SAM2Transforms.postprocess_masks (sam2/utils/transforms.py:76-115), on
    mask logits [..., H, W] before any resize: background components of at
    most `max_hole_area` pixels are raised to `mask_threshold` + 10, then
    foreground components of at most `max_sprinkle_area` pixels lowered to
    `mask_threshold` - 10."""
    if max_hole_area > 0:
        labels, areas = connected_components(masks <= mask_threshold)
        is_hole = (labels > 0) & (areas <= max_hole_area)
        masks = torch.where(
            is_hole, torch.full_like(masks, mask_threshold + 10.0), masks)
    if max_sprinkle_area > 0:
        labels, areas = connected_components(masks > mask_threshold)
        is_spr = (labels > 0) & (areas <= max_sprinkle_area)
        masks = torch.where(
            is_spr, torch.full_like(masks, mask_threshold - 10.0), masks)
    return masks
