"""Matching math (port of `no_time_to_train_tpu/models/matching/scoring.py`;
reference matching_baseline_utils.py:831-941): cosine similarity against the
class prototypes, negative-reference suppression and the semantic
intersection-over-self decay, with fixed shapes and validity masks."""
import torch

__all__ = ["mask_product", "mask_product_on_bf16", "masked_avg_feats",
           "sim_global_avg", "sim_global_avg_with_neg", "semantic_ios"]


def _l2n(x):
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def mask_product_on_bf16(masks_bool, other):
    """Whether `mask_product` takes bf16 operands: on a CUDA device, with a
    bf16 (or no) second operand. The device and the dtype decide, nothing
    else; the CPU has no product of bf16 operands into a float32 result."""
    return masks_bool.is_cuda and (other is None
                                   or other.dtype == torch.bfloat16)


def mask_product(masks_bool, other=None):
    """masks_bool [M, P] (0 / 1) times `other` [P, N], or times its own
    transpose, as float32 [M, N]. The JAX package runs both products of this
    module on bf16 operands with float32 accumulation; 0 / 1 masks and bf16
    features are exact as bf16, so against the float32 product (the CPU
    path, and float32 features anywhere) only the order of the float32 sums
    differs."""
    if mask_product_on_bf16(masks_bool, other):
        masks = masks_bool.to(torch.bfloat16)
        return torch.mm(masks, masks.T if other is None else other,
                        out_dtype=torch.float32)
    masks = masks_bool.float()
    return masks @ (masks.T if other is None else other.float())


def masked_avg_feats(tar_feat, masks_bool):
    """tar_feat [P, D]; masks_bool [M, P] -> L2-normalized pooled features
    [M, D] float32. Zero-area masks divide by 1. The pooling product takes
    tar_feat's values (0/1 masks are exact) with float32 accumulation."""
    msum = masks_bool.sum(dim=-1, keepdim=True).float()
    msum = torch.where(msum == 0, torch.ones_like(msum), msum)
    pooled = mask_product(masks_bool, tar_feat)
    return _l2n(pooled / msum)


def sim_global_avg(tar_feat, masks_bool, mem_feats_ins_avg):
    """Cosine of the masked-average target features with each class
    prototype (mean of the instance prototypes). Returns (sim [M, C],
    obj_feats [M, D])."""
    obj_feats = masked_avg_feats(tar_feat, masks_bool)
    mem_avg = _l2n(mem_feats_ins_avg.float().mean(dim=1))
    return obj_feats @ mem_avg.T, obj_feats


def sim_global_avg_with_neg(tar_feat, masks_bool, mem_feats_avg,
                            mem_feats_ins_avg_neg, sigma=1.0):
    """The positive similarity with exponential negative-reference
    suppression (reference :906-941): sim_pos * exp(-max(sim_neg - sim_pos,
    0) / sigma), sim_neg the largest over a class's negative instance
    prototypes. mem_feats_avg [C, D]; mem_feats_ins_avg_neg [C, L, D].
    Returns (sim [M, C], obj_feats [M, D])."""
    obj_feats = masked_avg_feats(tar_feat, masks_bool)
    n_classes, d = mem_feats_avg.shape
    mem_avg = _l2n(mem_feats_avg.float())
    neg = _l2n(mem_feats_ins_avg_neg.float()).reshape(-1, d)
    sim_pos = (obj_feats @ mem_avg.T).clamp(min=0.0)
    sim_neg = (obj_feats @ neg.T).clamp(min=0.0)
    sim_neg = sim_neg.reshape(masks_bool.shape[0], n_classes, -1).amax(dim=-1)
    out = sim_pos * torch.exp(-(sim_neg - sim_pos).clamp(min=0.0) / sigma)
    return out, obj_feats


def semantic_ios(masks_bool, labels, obj_sim, valid=None):
    """Per mask, the maximum over the other valid masks of its class of
    intersection * obj_sim / own_area * obj_sim (reference per-class loop,
    as one masked pairwise computation)."""
    masks = masks_bool
    if valid is not None:
        masks = masks & valid[:, None]
    pos_num = masks.sum(dim=-1).float()
    inter = mask_product(masks)
    m = masks.shape[0]
    same = (labels[:, None] == labels[None, :]) & ~torch.eye(
        m, dtype=torch.bool, device=masks.device)
    if valid is not None:
        same = same & valid[:, None] & valid[None, :]
    zero = torch.zeros_like(inter)
    inter = torch.where(same, inter, zero) * obj_sim
    ios = inter / pos_num[:, None].clamp(min=1.0) * obj_sim
    return torch.where(same, ios, zero).amax(dim=-1)
