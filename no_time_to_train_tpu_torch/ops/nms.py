"""Class-aware box NMS with fixed shapes (port of
`no_time_to_train_tpu/ops/nms.py`), in plain torch.

torchvision semantics: candidates are visited in decreasing score order and
a later box of the same class is suppressed when its IoU with a kept box is
strictly greater than the threshold. Invalid (padding) entries never
suppress and are never kept.
"""
import torch

__all__ = ["box_iou", "batched_nms", "take_first_kept"]


def box_iou(boxes_a, boxes_b):
    """IoU between [N, 4] and [M, 4] XYXY boxes (area without +1)."""
    a = boxes_a[:, None, :]
    b = boxes_b[None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((boxes_a[:, 2] - boxes_a[:, 0])
              * (boxes_a[:, 3] - boxes_a[:, 1]))[:, None]
    area_b = ((boxes_b[:, 2] - boxes_b[:, 0])
              * (boxes_b[:, 3] - boxes_b[:, 1]))[None, :]
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-30),
                       torch.zeros_like(inter))


def batched_nms(boxes, scores, classes, valid, iou_threshold):
    """boxes [N, 4] float, scores [N], classes [N] int, valid [N] bool.

    Returns (order [N] int64, keep [N] bool): `order` sorts candidates by
    decreasing score (invalid last, ties by index); keep[i] says whether
    candidate order[i] survives.

    The greedy result is the fixed point of
    keep[i] = valid[i] and no kept j < i suppresses i. Iterating that map
    from keep = valid settles one more link of the longest suppression chain
    per step, so it reaches the sequential answer exactly, in chain-length
    steps of one [N] x [N, N] product each instead of N sequential steps."""
    n = boxes.shape[0]
    sort_scores = torch.where(valid, scores,
                              torch.full_like(scores, float("-inf")))
    order = torch.argsort(-sort_scores, stable=True)
    b_sorted = boxes[order].float()
    c_sorted = classes[order]
    v_sorted = valid[order]
    iou = box_iou(b_sorted, b_sorted)
    sup = ((iou > iou_threshold) & (c_sorted[:, None] == c_sorted[None, :])
           & v_sorted[None, :] & v_sorted[:, None])
    sup = torch.triu(sup, diagonal=1).float()      # only earlier -> later
    keep = v_sorted.clone()
    for _ in range(n + 1):
        new = v_sorted & ((keep.float() @ sup) == 0)
        if torch.equal(new, keep):
            break
        keep = new
    return order, keep


def take_first_kept(order, keep, k):
    """Indices of the first k kept candidates in score order, padded with
    candidate order[0]; plus validity flags. Fixed shapes."""
    n = order.shape[0]
    rank = torch.cumsum(keep.long(), 0) - 1
    slot = torch.where(keep & (rank < k), rank, torch.full_like(rank, n))
    buf = torch.full((n + 1,), -1, dtype=torch.long, device=order.device)
    buf[slot] = torch.arange(n, device=order.device)
    sel_pos = buf[:k]
    valid_out = sel_pos >= 0
    sel_pos = torch.where(valid_out, sel_pos, torch.zeros_like(sel_pos))
    return order[sel_pos], valid_out
