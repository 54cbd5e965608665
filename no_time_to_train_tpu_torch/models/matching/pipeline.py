"""The NTTT matching pipeline (port of
`no_time_to_train_tpu/models/matching/pipeline.py`; reference
Sam2MatchingBaseline_noAMG.py), phases fill_memory -> postprocess_memory ->
test.

The test step: DINOv2 or DINOv3 features of the target, Hiera + FPN once, the point
grid decoded in chunks with the best of the multimask outputs kept, masked
average features scored against the bank (with negative references, against
both banks), class-aware NMS, semantic-IoS decay and top-K, all on the
model's device with fixed shapes. The winning low-resolution logits go to
the host, where `finalize_results` resizes them to the original image size.

`test` runs one image and fetches it; `test_async` queues one image and
returns device tensors for `fetch_test`, so that the next image can be
queued before the fetch; `test_batch_async` runs B images as one step: both
encoders at batch B, every decode chunk at B * chunk prompts.
"""
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from no_time_to_train_tpu_torch.config.hydra_yaml import resolve_sam2_cfg
from no_time_to_train_tpu_torch.config.presets import ENCODER_PRESETS
from no_time_to_train_tpu_torch.models.dino import DinoV2
from no_time_to_train_tpu_torch.models.dino_v3 import DinoV3, uses_gated_mlp
from no_time_to_train_tpu_torch.models.matching import memory_bank as mb
from no_time_to_train_tpu_torch.models.matching import scoring
from no_time_to_train_tpu_torch.models.sam2.factored_decode import (
    factored_best_of_multimask)
from no_time_to_train_tpu_torch.models.sam2.model import SAM2
from no_time_to_train_tpu_torch.ops.attention import (
    check_attention_impl, set_attention_impl)
from no_time_to_train_tpu_torch.ops.masks import batched_mask_to_box
from no_time_to_train_tpu_torch.ops.nms import batched_nms, take_first_kept
from no_time_to_train_tpu_torch.ops.resize import (
    _resize_matrix_np, resize, resize_hw)
from no_time_to_train_tpu_torch.utils.init import init_random_

__all__ = ["MatchingConfig", "NoAMGMatcher", "grid_points",
           "finalize_results", "finalize_records"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass(frozen=True)
class MatchingConfig:
    """sam2_infer_cfgs of the reference experiment YAMLs and the JAX
    package's options. `attention_impl` is set on this matcher's two
    encoders only. `encoder_quant="int8"` builds both towers' GEMMs as W8A8
    layers (ops/quant.py: the DINO layers, the Hiera trunk's blocks as the
    JAX package picks them); `decoder_impl="factored"` decodes the grid on
    the rank-factored form (models/sam2/factored_decode.py), one image at a
    time. Other values raise ValueError."""
    points_per_side: int = 32
    testing_point_bs: int = 256
    iou_thr: float = 0.4
    nms_thr: float = 0.5
    num_out_instance: int = 100
    kmeans_k: int = 4
    n_pca_components: int = 3
    cls_num_per_mask: int = 1
    with_negative_refs: bool = False
    neg_sigma: float = 0.8
    expand_ratio: int = 8
    analysis_res: int = 256
    compute_dtype: str = "float32"
    attention_impl: str = "pallas"
    encoder_quant: str = "none"
    decoder_impl: str = "dense"

    def __post_init__(self):
        if self.encoder_quant not in ("none", "int8"):
            raise ValueError(f"encoder_quant={self.encoder_quant!r}: "
                             "'none' or 'int8'")
        if self.decoder_impl not in ("dense", "factored"):
            raise ValueError(f"decoder_impl={self.decoder_impl!r}: "
                             "'dense' or 'factored'")


def grid_points(points_per_side, sam_input_size, device=None):
    """pps^2 (x, y) points at the grid's pixel centres (+0.5)."""
    a = np.linspace(0, sam_input_size - 1, points_per_side, dtype=np.float32)
    yy, xx = np.meshgrid(a, a, indexing="ij")
    pts = np.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1) + 0.5
    return torch.as_tensor(pts, device=device)


class NoAMGMatcher:
    """Owns the two models, the bank and the phase functions, on `device`.

    sam2_state_dict / dino_state_dict: reference-named state_dicts (numpy or
    torch values; HF Dinov2Model or DINOv3ViTModel names by the encoder's
    family); without them the weights are drawn from `seed` (norm
    scales 1, biases 0, other weights normal / sqrt(fan_in))."""

    def __init__(self, sam2_cfg="sam2_hiera_l.yaml", encoder_cfg="dinov2_large",
                 matching=MatchingConfig(), n_classes=20, memory_length=10,
                 sam2_state_dict=None, dino_state_dict=None, seed=0, *,
                 device):
        self.device = torch.device(device)
        check_attention_impl(matching.attention_impl)
        # a preset basename or a reference hydra YAML topology on disk
        self.sam2_cfg = (resolve_sam2_cfg(sam2_cfg) if isinstance(sam2_cfg, str)
                         else sam2_cfg)
        self.enc_cfg = (ENCODER_PRESETS[encoder_cfg]
                        if isinstance(encoder_cfg, str) else encoder_cfg)
        self.matching = matching
        self.dtype = getattr(torch, matching.compute_dtype)
        quant = matching.encoder_quant
        self.sam2 = self._build(partial(SAM2, encoder_quant=quant),
                                self.sam2_cfg, sam2_state_dict, seed)
        dino_cls = (partial(DinoV3, use_gated_mlp=uses_gated_mlp(self.enc_cfg),
                            quant=quant)
                    if self.enc_cfg.family == "dinov3"
                    else partial(DinoV2, quant=quant))
        self.dino = self._build(dino_cls, self.enc_cfg, dino_state_dict,
                                seed + 1)
        for model in (self.sam2, self.dino):
            set_attention_impl(model, matching.attention_impl)
        gs = self.enc_cfg.grid_size
        def new_bank():
            return mb.create(n_classes, memory_length, gs * gs,
                             self.enc_cfg.feat_dim, matching.kmeans_k,
                             matching.n_pca_components, device=self.device)

        self.bank = new_bank()
        self.bank_neg = new_bank() if matching.with_negative_refs else None
        self._mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.as_tensor(IMAGENET_STD, device=self.device)

    def _build(self, cls, cfg, state_dict, seed):
        with torch.device("meta"):
            model = cls(cfg)
        model = model.to_empty(device=self.device)
        if state_dict is None:
            init_random_(model, torch.Generator(self.device).manual_seed(seed))
        else:
            sd = {k: torch.as_tensor(np.array(v)) for k, v in
                  state_dict.items()}
            model.load_state_dict(sd, strict=True)
        # weights live in the compute dtype, as the JAX package pre-casts
        # them; W8A8 layers keep float32 masters (ops/quant.Int8Linear)
        return model.to(self.dtype).eval().requires_grad_(False)

    def _normalize(self, img):
        return (img - self._mean) / self._std

    def _as_tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype, device=self.device)

    # ----------------------------------------------------------------- fill
    @torch.no_grad()
    def _fill_features(self, ref_imgs, ref_masks):
        """ref_imgs [S, H, W, 3] in [0, 1]; ref_masks [S, Hm, Wm] ->
        feats [S, N, D] float32, masks [S, N]."""
        e, gs = self.enc_cfg.img_size, self.enc_cfg.grid_size
        imgs = self._normalize(resize(ref_imgs, (e, e), mode="bicubic"))
        feats = self.dino(imgs.to(self.dtype)).float()
        masks = resize_hw(ref_masks.float(), (gs, gs), mode="nearest")
        return feats, masks.reshape(masks.shape[0], -1)

    def fill_memory(self, ref_imgs, ref_masks, cat_inds, positive=True):
        """Write references into the positive or the negative bank; raises
        IndexError when a class receives more than `memory_length`."""
        if not positive and self.bank_neg is None:
            raise ValueError("the negative bank needs "
                             "MatchingConfig(with_negative_refs=True)")
        feats, masks = self._fill_features(self._as_tensor(ref_imgs),
                                           self._as_tensor(ref_masks))
        if positive:
            self.bank = mb.fill(self.bank, cat_inds, feats, masks)
        else:
            self.bank_neg = mb.fill(self.bank_neg, cat_inds, feats, masks)

    def postprocess_memory(self, positive=True, seed=0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if positive:
            self.bank = mb.postprocess(self.bank, gen)
        else:
            self.bank_neg = mb.postprocess(self.bank_neg, gen)

    # ----------------------------------------------------------------- test
    def _decode_grid_batch(self, imgs):
        """Hiera + FPN once at the batch of imgs [B, S, S, 3], then the grid
        decoded in chunks of B * chunk prompts; under `decoder_impl=
        "factored"` each image's chunk on its own factored form, whose shared
        base is one image's embedding. Returns (lr_masks [B, P, 4h, 4w] in
        the compute dtype, pred_ious [B, P], points [P, 2])."""
        m = self.matching
        s = self.sam2_cfg.image_size
        n_img = imgs.shape[0]
        backbone = self.sam2.forward_image(
            self._normalize(imgs).to(self.dtype))
        fpn = backbone["backbone_fpn"]
        feats, hr = fpn[-1], [fpn[0], fpn[1]]
        pts = grid_points(m.points_per_side, s, self.device)
        n_pts = pts.shape[0]
        chunk = min(m.testing_point_bs, n_pts)
        if n_pts % chunk:
            raise ValueError(f"{n_pts} grid points do not split into chunks "
                             f"of {chunk}")
        lrs, ious = [], []
        labels = torch.ones((chunk, 1), dtype=torch.long, device=self.device)
        decode = (self._decode_chunk_factored
                  if m.decoder_impl == "factored"
                  else self.sam2.forward_sam_heads_best)
        for pc in pts.reshape(n_pts // chunk, chunk, 1, 2):
            lr, iou = decode(feats, pc, labels, hr)
            lrs.append(lr.reshape(n_img, chunk, *lr.shape[1:]))
            ious.append(iou.reshape(n_img, chunk))
        return torch.cat(lrs, dim=1), torch.cat(ious, dim=1), pts

    def _decode_chunk_factored(self, feats, pc, labels, hr):
        """`forward_sam_heads_best` on the factored form, image by image
        (JAX `_decode_grid`'s factored branch): (mask [Bi * chunk, 4h, 4w]
        in the compute dtype, iou [Bi * chunk]), image-major."""
        pe = self.sam2.sam_prompt_encoder
        sparse = pe.embed_points(pc, labels)
        dense_pe, no_mask = pe.get_dense_pe(), pe.no_mask_dense()
        outs = [factored_best_of_multimask(
            self.sam2.sam_mask_decoder, feats[b:b + 1], dense_pe, sparse,
            no_mask, None if hr is None else [f[b:b + 1] for f in hr])
            for b in range(feats.shape[0])]
        return (torch.cat([o[0] for o in outs]).to(self.dtype),
                torch.cat([o[1] for o in outs]))

    def _decode_grid(self, img):
        """One image [S, S, 3]: (lr_masks [P, 4h, 4w], pred_ious [P],
        points [P, 2])."""
        lr, ious, pts = self._decode_grid_batch(img[None])
        return lr[0], ious[0], pts

    def _target_features(self, tar_imgs):
        """DINO features [B, gs * gs, D] float32 of tar_imgs [B, S, S, 3]."""
        e = self.enc_cfg.img_size
        enc_in = self._normalize(resize(tar_imgs, (e, e), mode="bicubic"))
        return self.dino(enc_in.to(self.dtype)).float()

    @torch.no_grad()
    def _test_impl(self, tar_img):
        """tar_img: [S, S, 3] float in [0, 1] on the device. Returns the
        padded result dict of the reference forward_test (:562-698).
        Nothing here waits for the device."""
        tar_feat = self._target_features(tar_img[None])[0]
        lr, pred_ious, _ = self._decode_grid(tar_img)
        return self._match(tar_feat, lr, pred_ious)

    @torch.no_grad()
    def _test_batch_impl(self, tar_imgs):
        """tar_imgs: [B, S, S, 3]: both encoders at batch B, every decode
        chunk at B * chunk prompts, then the tail per image. Returns the
        result dict of `_test_impl` with a leading B axis."""
        tar_feats = self._target_features(tar_imgs)
        lrs, pred_ious, _ = self._decode_grid_batch(tar_imgs)
        outs = [self._match(tar_feats[b], lrs[b], pred_ious[b])
                for b in range(tar_imgs.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def _match(self, tar_feat, lr, pred_ious):
        """Scoring, NMS, IoS decay and top-K of one image: tar_feat
        [gs * gs, D] float32, lr [P, 4h, 4w], pred_ious [P]."""
        m = self.matching
        gs = self.enc_cfg.grid_size
        bank = self.bank
        n_masks, lr_res = lr.shape[0], lr.shape[-1]
        valid = pred_ious > m.iou_thr

        feat_sp = resize(tar_feat.reshape(gs, gs, -1)[None], (lr_res, lr_res),
                         mode="bilinear", antialias=True)[0]
        feat_sp = feat_sp.reshape(lr_res * lr_res, -1).to(self.dtype)
        masks_bool = (lr > 0).reshape(n_masks, -1)
        if m.with_negative_refs:
            sim, obj_feats = scoring.sim_global_avg_with_neg(
                feat_sp, masks_bool, bank.feats_avg,
                self.bank_neg.feats_ins_avg, sigma=m.neg_sigma)
        else:
            sim, obj_feats = scoring.sim_global_avg(feat_sp, masks_bool,
                                                    bank.feats_ins_avg)

        n_classes = bank.feats_ins_avg.shape[0]
        k = n_classes if m.cls_num_per_mask == -1 else m.cls_num_per_mask
        # stable sort: ties go to the lower class index, as lax.top_k does
        top_scores, labels = torch.sort(sim, dim=1, descending=True,
                                        stable=True)
        top_scores, labels = top_scores[:, :k], labels[:, :k]
        if k == n_classes:
            top_scores = top_scores * (top_scores > top_scores[:, :1] * 0.6)
        labels = labels.reshape(-1)
        scores_all = top_scores.reshape(-1)

        lr_boxes = batched_mask_to_box(lr > 0).float()
        order, keep = batched_nms(lr_boxes.repeat_interleave(k, 0),
                                  pred_ious.float().repeat_interleave(k, 0),
                                  labels, valid.repeat_interleave(k, 0),
                                  m.nms_thr)
        out_num = min(m.num_out_instance * m.expand_ratio, n_masks * k)
        sel, sel_valid = take_first_kept(order, keep, out_num)
        scores_out = scores_all[sel]
        labels_out = labels[sel]
        mask_idx = sel // k
        sel_valid = sel_valid & (scores_out > 0.0)

        ar = m.analysis_res
        lr_sel = lr[mask_idx]
        n_sel = lr_sel.shape[0]
        if ar == lr_res:
            bin_up = (lr_sel > 0).reshape(n_sel, ar * ar)
        else:
            bin_up = (resize_hw(lr_sel, (ar, ar), mode="bilinear") > 0) \
                .reshape(n_sel, ar * ar)

        obj_out = obj_feats[mask_idx]
        obj_sim = (obj_out @ obj_out.T).clamp(min=0.0)
        ios = scoring.semantic_ios(bin_up, labels_out, obj_sim,
                                   valid=sel_valid)
        scores_out = scores_out * torch.sqrt((1.0 - ios).clamp(min=0.0))

        final_n = min(m.num_out_instance, n_sel)
        key = torch.where(sel_valid, -scores_out,
                          torch.full_like(scores_out, float("inf")))
        ranked = torch.argsort(key, stable=True)[:final_n]
        f_valid = sel_valid[ranked]
        return dict(
            lr_logits=lr_sel[ranked].half(),
            scores=torch.where(f_valid, scores_out[ranked],
                               torch.zeros_like(scores_out[ranked])),
            labels=labels_out[ranked],
            pred_ious=pred_ious[mask_idx][ranked],
            valid=f_valid)

    def test(self, tar_img):
        """tar_img: [S, S, 3] float in [0, 1]. Returns a numpy dict with
        `lr_logits` [K, 4h, 4w] float16, `scores`, `labels`, `pred_ious`,
        `valid`; valid entries form a prefix."""
        return self.fetch_test(self.test_async(tar_img))

    def test_async(self, tar_img):
        """Queue one test step and return its outputs on the device without
        waiting for them. `fetch_test` brings them to the host; queue the
        next image first to overlap its work with the fetch."""
        return self._test_impl(self._as_tensor(tar_img))

    def test_batch_async(self, tar_imgs):
        """tar_imgs [B, S, S, 3]: B images as one step, outputs on the
        device with a leading B axis (`fetch_test` takes them too)."""
        return self._test_batch_impl(self._as_tensor(tar_imgs))

    @staticmethod
    def fetch_test(out):
        """Device outputs -> numpy; only the valid prefix of the logits is
        copied. A batched output gives the same dict with a leading B
        axis."""
        if out["valid"].dim() == 2:
            per = [NoAMGMatcher.fetch_test({k: v[b] for k, v in out.items()})
                   for b in range(out["valid"].shape[0])]
            return {k: np.stack([o[k] for o in per]) for k in per[0]}
        valid = out["valid"].cpu().numpy()
        n = int(valid.sum())
        lr = np.zeros(tuple(out["lr_logits"].shape), np.float16)
        if n > 0:
            lr[:n] = out["lr_logits"][:n].cpu().numpy()
        return dict(lr_logits=lr, scores=out["scores"].float().cpu().numpy(),
                    labels=out["labels"].cpu().numpy(),
                    pred_ious=out["pred_ious"].float().cpu().numpy(),
                    valid=valid)


def finalize_records(out, ori_h, ori_w):
    """Per winning mask, one native pass upsamples, binarizes, RLE-encodes
    and boxes (native/nttt_native.cpp finalize_mask). Returns dict(segs,
    bboxes, scores, labels), or None when the native library is missing or
    the image is smaller than the logits (callers then use
    finalize_results)."""
    from no_time_to_train_tpu_torch.utils import native
    if not native.has_finalize():
        return None
    lr = out["lr_logits"].shape[-1]
    if ori_h < lr or ori_w < lr:
        return None
    n = int(np.asarray(out["valid"]).sum())
    logits = np.asarray(out["lr_logits"][:n], np.float32)
    segs, bboxes = [], np.zeros((n, 4), np.float32)
    for i in range(n):
        counts, box, _ = native.finalize_mask(logits[i], ori_h, ori_w)
        segs.append({"size": [ori_h, ori_w], "counts": counts})
        bboxes[i] = box
    return dict(segs=segs, bboxes=bboxes,
                scores=np.asarray(out["scores"][:n], np.float32),
                labels=np.asarray(out["labels"][:n]))


def finalize_results(out, ori_h, ori_w, exact_resize=False):
    """Upsample the winning low-resolution logits to the original size
    (reference antialiased bilinear + >0, :657-663), box them and drop the
    padding. exact_resize=True, an image smaller than the logits or a
    missing native library use the torch-parity separable weights in numpy;
    otherwise the native library upsamples."""
    valid = np.asarray(out["valid"])
    n = int(valid.sum())
    logits = np.asarray(out["lr_logits"][:n], np.float32)
    scores = np.asarray(out["scores"][:n], np.float32)
    labels = np.asarray(out["labels"][:n])
    if n == 0:
        return dict(binary_masks=np.zeros((0, ori_h, ori_w), bool),
                    bboxes=np.zeros((0, 4), np.float32),
                    scores=scores, labels=labels)
    lr = logits.shape[-1]
    masks = None
    if not (exact_resize or ori_h < lr or ori_w < lr):
        from no_time_to_train_tpu_torch.utils import native
        masks = native.upsample_binarize(logits, ori_h, ori_w)
    if masks is None:
        wh = _resize_matrix_np(lr, ori_h, "bilinear", ori_h < lr).astype(np.float32)
        ww = _resize_matrix_np(lr, ori_w, "bilinear", ori_w < lr).astype(np.float32)
        up = np.einsum("oh,nhw->now", wh, logits)
        masks = np.einsum("ow,nhw->nho", ww, up) > 0
    masks = np.ascontiguousarray(masks)
    rows = masks.any(axis=2)
    cols = masks.any(axis=1)
    has = rows.any(axis=1)
    y0 = rows.argmax(axis=1)
    y1 = ori_h - 1 - rows[:, ::-1].argmax(axis=1)
    x0 = cols.argmax(axis=1)
    x1 = ori_w - 1 - cols[:, ::-1].argmax(axis=1)
    bboxes = np.where(has[:, None],
                      np.stack([x0, y0, x1, y1], 1).astype(np.float32), 0.0)
    return dict(binary_masks=masks, bboxes=bboxes, scores=scores,
                labels=labels)
