"""Plain float32 few-shot matching (No Time to Train's NoAMG test step,
`Sam2MatchingBaseline_noAMG.forward_test`) over the models of
`reference.models`: the memory bank's class prototypes from the reference
images, then per target image the 32 x 32 grid decode, masked-average
features scored against the prototypes, class-aware box NMS in greedy
order, the semantic-IoS decay and the top-K; and the upsampling of winning
logits to the original image size.

Every step returns what the benchmark's comparison reads: for each grid
prompt its mask logits, predicted IoU, class similarities and box, and the
reference's own list of outputs. Nothing here imports the program or JAX.
"""
import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import models

__all__ = ["float32_exact", "normalize", "ref_block", "prototypes", "Step",
           "match", "mask_boxes", "box_iou", "analysis_masks",
           "semantic_ios", "upsample"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def float32_exact():
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def normalize(img):
    """[..., 3] in [0, 1] -> ImageNet-normalized."""
    mean = img.new_tensor(IMAGENET_MEAN)
    std = img.new_tensor(IMAGENET_STD)
    return (img - mean) / std


def _resize_nhwc(x, size, mode, antialias=False):
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode=mode,
                      antialias=antialias,
                      align_corners=None if mode == "nearest" else False)
    return y.permute(0, 2, 3, 1)


def _l2n(x):
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


# a block of references in `prototypes`: at most 8, and its encoder's
# largest float32 intermediates within 4 GiB
REF_BLOCK, REF_BLOCK_BYTES = 8, 4 * 2 ** 30


def ref_block(dino_cfg):
    """References a block of `prototypes`: `REF_BLOCK`, fewer where three
    copies of a block's attention logits, or of its MLP's hidden rows, in
    float32 pass `REF_BLOCK_BYTES`, so that a wide encoder's blocks fit
    beside its weights."""
    g = dino_cfg["img_size"] // dino_cfg["patch_size"]
    n = g * g + 1 + dino_cfg.get("registers", 0)
    hidden = dino_cfg.get("mlp_hidden",
                          dino_cfg.get("mlp_ratio", 4) * dino_cfg["dim"])
    per_image = 3 * 4 * max(dino_cfg["heads"] * n * n, 2 * n * hidden)
    return max(1, min(REF_BLOCK, REF_BLOCK_BYTES // per_image))


@torch.no_grad()
def prototypes(dino_sd, dino_cfg, ref_imgs, ref_masks, cat_inds, n_classes,
               block=None):
    """Class prototypes [C, D]: per reference the mask-weighted mean of its
    DINO patch features (the mask resized to the patch grid by nearest),
    per class the L2-normalized mean of its references' means, the
    references run through the encoder in blocks of `block` (`ref_block`
    where None).
    ref_imgs [R, S, S, 3] in [0, 1]; ref_masks [R, Hm, Wm]."""
    block = block or ref_block(dino_cfg)
    e, p = dino_cfg["img_size"], dino_cfg["patch_size"]
    gs = e // p
    sums = None
    counts = torch.zeros(n_classes, device=ref_imgs.device)
    for s in range(0, ref_imgs.shape[0], block):
        imgs = ref_imgs[s:s + block].float()
        if imgs.shape[1] != e:
            imgs = _resize_nhwc(imgs, (e, e), "bicubic")
        feats = models.dino_features(dino_sd, dino_cfg, normalize(imgs))
        masks = F.interpolate(ref_masks[s:s + block, None].float(),
                              size=(gs, gs), mode="nearest").flatten(1)
        area = masks.sum(1, keepdim=True)
        area = torch.where(area == 0, torch.ones_like(area), area)
        inst = (feats * masks[..., None]).sum(1) / area
        if sums is None:
            sums = inst.new_zeros((n_classes, inst.shape[1]))
        idx = torch.as_tensor(list(cat_inds[s:s + block]),
                              device=inst.device)
        sums.index_add_(0, idx, inst)
        counts.index_add_(0, idx, torch.ones_like(idx, dtype=counts.dtype))
    return _l2n(sums / counts.clamp(min=1)[:, None])


def mask_boxes(masks):
    """XYXY boxes of boolean masks [N, H, W] (inclusive pixel indices;
    empty masks give zeros)."""
    n, h, w = masks.shape
    rows, cols = masks.any(2), masks.any(1)
    has = rows.any(1)
    ar_h = torch.arange(h, device=masks.device)
    ar_w = torch.arange(w, device=masks.device)
    top = torch.where(rows, ar_h, h).amin(1)
    bottom = torch.where(rows, ar_h, -1).amax(1)
    left = torch.where(cols, ar_w, w).amin(1)
    right = torch.where(cols, ar_w, -1).amax(1)
    box = torch.stack([left, top, right, bottom], 1)
    return torch.where(has[:, None], box, torch.zeros_like(box)).float()


def box_iou(a, b):
    """IoU of XYXY boxes [N, 4] x [M, 4], areas without +1."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None]
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-30),
                       torch.zeros_like(inter))


def analysis_masks(logits, res):
    """Binary masks [N, res, res] of logits [N, h, w] for the IoS:
    thresholded at 0 after a bilinear resize where res differs."""
    if logits.shape[-1] != res:
        logits = F.interpolate(logits[:, None].float(), size=(res, res),
                               mode="bilinear", align_corners=False)[:, 0]
    return logits > 0


def semantic_ios(masks, labels, obj_feats):
    """Per mask, the largest over the other masks of its class of
    intersection * sim^2 / own area, sim the clamped cosine of their pooled
    features (NTTT's semantic intersection over self)."""
    m = masks.reshape(masks.shape[0], -1).float()
    inter = m @ m.T
    area = m.sum(1).clamp(min=1.0)
    sim = (obj_feats @ obj_feats.T).clamp(min=0.0)
    same = (labels[:, None] == labels[None, :]) & ~torch.eye(
        len(labels), dtype=torch.bool, device=m.device)
    ios = torch.where(same, inter * sim * sim / area[:, None],
                      torch.zeros_like(inter))
    return ios.amax(1) if len(labels) else ios.new_zeros(0)


def upsample(logits, ori_h, ori_w):
    """Low-resolution logits [N, h, w] -> float32 logits at the original
    size by bilinear interpolation (antialiased where it shrinks)."""
    lr = logits.shape[-1]
    shrink = ori_h < lr or ori_w < lr
    return F.interpolate(logits[:, None].float(), size=(ori_h, ori_w),
                         mode="bilinear", align_corners=False,
                         antialias=shrink)[:, 0]


class Step:
    """The test step of one configuration on float32 copies of the
    weights. `cfg` is the configuration file's dict."""

    def __init__(self, cfg, sam2_sd, dino_sd, protos, device, block=64):
        self.topo = cfg["topology"]
        self.matching = cfg["matching"]
        self.sam2_sd, self.dino_sd = sam2_sd, dino_sd
        self.protos = protos
        self.device = device
        self.block = block

    @torch.no_grad()
    def __call__(self, img):
        """img [S, S, 3] float in [0, 1]. Returns a dict of per-prompt
        tensors (`lr` [P, 4h, 4w], `iou` [P], `sim` [P, C], `feats` [P, D],
        `boxes` [P, 4]), `outputs`, the reference's own detections in rank
        order as (prompt, label, score), and what scores any mask: the
        target's features at the mask resolution `feat_sp` [(4h)(4w), D]
        and the class prototypes `protos` [C, D]."""
        t, m = self.topo, self.matching
        dino = t["dino"]
        img = img.float().to(self.device)[None]
        e = dino["img_size"]
        tar_feat = models.dino_features(
            self.dino_sd, dino, normalize(_resize_nhwc(img, (e, e), "bicubic")))
        feats = models.image_encoder(self.sam2_sd, t["hiera"], normalize(img))
        side = feats[2].shape[1]
        pe = models.dense_pe(self.sam2_sd, side)
        s = t["hiera"]["image_size"]
        a = np.linspace(0, s - 1, m["points_per_side"], dtype=np.float32)
        yy, xx = np.meshgrid(a, a, indexing="ij")
        pts = torch.as_tensor(np.stack([xx.ravel(), yy.ravel()], -1) + 0.5,
                              device=self.device)
        lrs, ious, every = [], [], []
        for b in range(0, pts.shape[0], self.block):
            sparse = models.embed_points(self.sam2_sd, pts[b:b + self.block], s)
            lr, iou, all_lr = models.decode_best(
                self.sam2_sd, t["decoder"], feats, pe, sparse, all_masks=True)
            lrs.append(lr)
            ious.append(iou)
            every.append(all_lr)
        lr = torch.cat(lrs)
        out = match(tar_feat[0], lr > 0, torch.cat(ious), self.protos,
                    self.topo["dino"], m, lr=lr)
        out.update(lr=lr, lr_all=torch.cat(every), dino=tar_feat[0],
                   embedding=feats[2][0])
        return out


@torch.no_grad()
def match(tar_feat, masks, iou, protos, dino_cfg, m, lr=None):
    """Scoring, class-aware box NMS, the semantic-IoS decay and the top-K
    of one image: tar_feat [gs * gs, D] DINO patch features, masks
    [P, r, r] bool (the decoded masks > 0), iou [P] predicted IoUs, protos
    [C, D]. `lr` (the logits) is read only where `analysis_res` differs
    from r. Returns per prompt `sim` [P, C], `feats` [P, D], `boxes`
    [P, 4]; `order` (the valid prompts in NMS order), `nms_kept` (those
    NMS keeps, in order, before the cut to `num_out_instance *
    expand_ratio`), `cap` (that cut), `decayed` {prompt: IoS-decayed
    score} of the candidates that pass the cut and score > 0, and
    `outputs`, the detections in rank order as (prompt, label, score)."""
    gs = dino_cfg["img_size"] // dino_cfg["patch_size"]
    n, res = masks.shape[0], masks.shape[-1]
    if m["analysis_res"] != res and lr is None:
        raise ValueError(f"analysis_res {m['analysis_res']} differs from "
                         f"the masks' {res}: the IoS needs the logits")
    feat_sp = _resize_nhwc(tar_feat.float().reshape(1, gs, gs, -1),
                           (res, res), "bilinear", antialias=True)[0]
    flat = masks.reshape(n, -1).float()
    area = flat.sum(1, keepdim=True)
    area = torch.where(area == 0, torch.ones_like(area), area)
    obj = _l2n((flat @ feat_sp.reshape(res * res, -1)) / area)
    sim = obj @ protos.T
    boxes = mask_boxes(masks)
    if m["cls_num_per_mask"] != 1:
        raise NotImplementedError("the reference labels a mask with its "
                                  "best class only (cls_num_per_mask 1)")
    score, label = sim.max(1)
    # greedy class-aware NMS in decreasing predicted IoU, ties by index
    valid = torch.nonzero(iou > m["iou_thr"]).flatten().tolist()
    order = sorted(valid, key=lambda p: (-float(iou[p]), p))
    kept = []
    if order:
        ov = box_iou(boxes[order], boxes[order]).cpu().numpy()
        lab = label[order].cpu().numpy()
        for i in range(len(order)):
            if not any(ov[i, j] > m["nms_thr"] and lab[i] == lab[j]
                       for j in kept):
                kept.append(i)
    nms_kept = [order[i] for i in kept]
    cap = m["num_out_instance"] * m.get("expand_ratio", 8)
    cand = [p for p in nms_kept[:cap] if float(score[p]) > 0.0]
    outputs, decayed = [], {}
    if cand:
        idx = torch.as_tensor(cand, device=masks.device)
        ar = m["analysis_res"]
        sel = (masks[idx] if ar == res
               else analysis_masks(lr[idx], ar))
        ios = semantic_ios(sel, label[idx], obj[idx])
        dec = score[idx] * torch.sqrt((1.0 - ios).clamp(min=0.0))
        decayed = {p: float(d) for p, d in zip(cand, dec)}
        rank = sorted(range(len(cand)), key=lambda i: (-float(dec[i]), i))
        outputs = [(cand[i], int(label[cand[i]]), float(dec[i]))
                   for i in rank[:m["num_out_instance"]]]
    return dict(iou=iou, sim=sim, feats=obj, boxes=boxes, order=order,
                nms_kept=nms_kept, cap=cap, decayed=decayed,
                outputs=outputs, feat_sp=feat_sp.reshape(res * res, -1),
                protos=protos)
