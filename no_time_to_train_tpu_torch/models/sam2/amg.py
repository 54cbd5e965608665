"""Automatic mask generator (port of `no_time_to_train_tpu/models/sam2/amg.py`;
reference sam2/automatic_mask_generator.py).

The point grid of each crop decodes in chunks of `points_per_batch` prompts
through `SAM2.forward_sam_heads(..., output_all_masks=True)` (the classic
mask decoder), and the filters run on the device as validity masks:
predicted IoU, stability score, box NMS. The kept masks are upscaled and
thresholded on the device in chunks of 64 and fetched as booleans; the
records (box, area, RLE) are made on the host. Crops loop on the host with a
cross-crop NMS at the end, as in the reference (:224-293).
"""
import numpy as np
import torch

from no_time_to_train_tpu_torch.data import rle as rle_mod
from no_time_to_train_tpu_torch.models.sam2.image_predictor import (
    encode_image)
from no_time_to_train_tpu_torch.ops.connected_components import (
    connected_components)
from no_time_to_train_tpu_torch.ops.masks import (
    batched_mask_to_box, stability_score)
from no_time_to_train_tpu_torch.ops.nms import batched_nms
from no_time_to_train_tpu_torch.ops.resize import resize_hw

__all__ = ["build_point_grid", "build_all_layer_point_grids",
           "generate_crop_boxes", "SAM2AutomaticMaskGenerator"]

_UPSCALE_CHUNK = 64


def build_point_grid(n_per_side):
    """amg.py:181: a normalized [0, 1] grid of pixel centres, [n^2, 2]."""
    offset = 1.0 / (2 * n_per_side)
    pts = np.linspace(offset, 1 - offset, n_per_side)
    gx, gy = np.meshgrid(pts, pts)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)


def build_all_layer_point_grids(n_per_side, n_layers, scale_per_layer):
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size, n_layers, overlap_ratio):
    """amg.py:202: XYXY crop boxes (the whole image first) and their layer
    indices."""
    crop_boxes, layer_idxs = [], []
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes.append([0, 0, im_w, im_h])
    layer_idxs.append(0)

    def crop_len(orig_len, n_crops, overlap):
        return int(np.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_crops_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_crops_per_side))
        crop_w = crop_len(im_w, n_crops_per_side, overlap)
        crop_h = crop_len(im_h, n_crops_per_side, overlap)
        crop_box_x0 = [int((crop_w - overlap) * i)
                       for i in range(n_crops_per_side)]
        crop_box_y0 = [int((crop_h - overlap) * i)
                       for i in range(n_crops_per_side)]
        for x0 in crop_box_x0:
            for y0 in crop_box_y0:
                crop_boxes.append([x0, y0, min(x0 + crop_w, im_w),
                                   min(y0 + crop_h, im_h)])
                layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def _xywh(binary):
    """The tight XYWH box of a non-empty [H, W] mask, from its row and
    column projections."""
    ys = np.flatnonzero(binary.any(axis=1))
    xs = np.flatnonzero(binary.any(axis=0))
    return [int(xs[0]), int(ys[0]), int(xs[-1] - xs[0]), int(ys[-1] - ys[0])]


class SAM2AutomaticMaskGenerator:
    """Works on the device and in the dtype of the SAM2 module it is
    given."""

    def __init__(self, model, points_per_side=32, points_per_batch=256,
                 pred_iou_thresh=0.8, stability_score_thresh=0.95,
                 stability_score_offset=1.0, mask_threshold=0.0,
                 box_nms_thresh=0.7, crop_n_layers=0, crop_nms_thresh=0.7,
                 crop_overlap_ratio=512 / 1500,
                 crop_n_points_downscale_factor=1, min_mask_region_area=0,
                 output_mode="binary_mask", multimask_output=True,
                 use_m2m=False):
        if output_mode not in ("binary_mask", "coco_rle"):
            raise ValueError(f"output_mode {output_mode!r}")
        self.model = model
        self.device = next(model.parameters()).device
        self.point_grids = build_all_layer_point_grids(
            points_per_side, crop_n_layers, crop_n_points_downscale_factor)
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.mask_threshold = mask_threshold
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode
        self.multimask_output = multimask_output
        self.use_m2m = use_m2m
        # candidates, those that reach the NMS and those kept, summed over
        # the crops of the last `generate`
        self.last_counts = None

    @property
    def masks_per_prompt(self):
        """Candidates a prompt gives: the three multimask outputs, or the
        single mask."""
        return 3 if self.multimask_output else 1

    def _decode_chunks(self, fpn, pts, labels, mask_inputs=None,
                       multimask_output=None):
        """Prompts pts [P, n, 2] (model pixels), labels [P, n] with P a
        multiple of the chunk, mask_inputs [P, 4h, 4w] or None, through
        `forward_sam_heads` with all four masks out, chunk by chunk.
        Returns the candidates (logits [P * m, 4h, 4w] float32, ious
        [P * m]), prompt-major: channels 1..3 with `multimask_output`
        (default: the generator's), channel 0 otherwise."""
        if multimask_output is None:
            multimask_output = self.multimask_output
        feats, hr = fpn[-1], [fpn[0], fpn[1]]
        chunk = min(self.points_per_batch, pts.shape[0])
        sel = slice(1, 4) if multimask_output else slice(0, 1)
        masks, ious = [], []
        for c0 in range(0, pts.shape[0], chunk):
            mi = (None if mask_inputs is None
                  else mask_inputs[c0:c0 + chunk, ..., None])
            m4, i4, _, _ = self.model.forward_sam_heads(
                feats, pts[c0:c0 + chunk], labels[c0:c0 + chunk], mi, hr,
                multimask_output, True)
            masks.append(m4[:, sel].reshape(-1, *m4.shape[-2:]))
            ious.append(i4[:, sel].reshape(-1).float())
        return torch.cat(masks), torch.cat(ious)

    def _filter(self, masks, ious, valid):
        """The pre-NMS filters on the device: predicted IoU, stability.
        Returns (keep, stability, boxes float32 XYXY in mask pixels)."""
        keep = valid
        if self.pred_iou_thresh > 0:
            keep = keep & (ious > self.pred_iou_thresh)
        stab = stability_score(masks, self.mask_threshold,
                               self.stability_score_offset)
        if self.stability_score_thresh > 0:
            keep = keep & (stab >= self.stability_score_thresh)
        boxes = batched_mask_to_box(masks > self.mask_threshold).float()
        return keep, stab, boxes

    def _nms(self, boxes, scores, keep, thresh):
        order, nms_keep = batched_nms(
            boxes, scores, torch.zeros_like(keep, dtype=torch.long), keep,
            thresh)
        final = torch.zeros_like(keep)
        final[order] = nms_keep
        return final

    @torch.no_grad()
    def _decode(self, img, points01):
        """img: [H, W, 3] in [0, 1] (a crop, resized to the model's
        resolution); points01 [P, 2] normalized. Returns per candidate
        (logits [K, 4h, 4w] float32, iou, stability, boxes, keep before the
        NMS, keep after it), K = P * masks_per_prompt."""
        s = self.model.cfg.image_size
        fpn = encode_image(self.model, img)
        n_points = points01.shape[0]
        chunk = min(self.points_per_batch, n_points)
        pad = -n_points % chunk
        pts = np.pad(np.asarray(points01, np.float32) * np.float32(s),
                     ((0, pad), (0, 0)))
        pts = torch.as_tensor(pts, device=self.device)[:, None]
        labels = torch.ones(pts.shape[:2], dtype=torch.long,
                            device=self.device)
        masks, ious = self._decode_chunks(fpn, pts, labels)
        m = self.masks_per_prompt
        valid = torch.arange(masks.shape[0], device=self.device) // m \
            < n_points
        if self.use_m2m:
            # one refinement step: each candidate re-prompted with its point
            # and its own low-resolution mask, single-mask output (reference
            # automatic_mask_generator.py:330-351, refine_with_m2m :437-454);
            # the filters below then act on the refined masks
            masks, ious = self._decode_chunks(
                fpn, pts.repeat_interleave(m, 0),
                labels.repeat_interleave(m, 0), masks,
                multimask_output=False)
        keep, stab, boxes = self._filter(masks, ious, valid)
        final = self._nms(boxes, ious, keep, self.box_nms_thresh)
        return masks, ious, stab, boxes, keep, final

    def _upscale(self, masks, idxs, hw):
        """Masks[idxs] resized to hw and thresholded on the device, 64 at a
        time, fetched as booleans [len(idxs), *hw]."""
        out = []
        for c0 in range(0, len(idxs), _UPSCALE_CHUNK):
            sub = torch.as_tensor(idxs[c0:c0 + _UPSCALE_CHUNK],
                                  device=masks.device)
            seg = resize_hw(masks[sub], hw, mode="bilinear") \
                > self.mask_threshold
            out.append(seg.cpu().numpy())
        return (np.concatenate(out) if out
                else np.zeros((0, *hw), bool))

    def generate(self, image):
        """image: [H, W, 3] float in [0, 1] (numpy). Returns a list of
        record dicts (segmentation, area, bbox XYWH, predicted_iou,
        point_coords, stability_score, crop_box), as the reference does."""
        oh, ow = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(
            (oh, ow), self.crop_n_layers, self.crop_overlap_ratio)
        m = self.masks_per_prompt
        self.last_counts = dict(candidates=0, into_nms=0, kept=0)
        all_recs = []
        for crop_box, layer_idx in zip(crop_boxes, layer_idxs):
            x0, y0, x1, y1 = crop_box
            crop = image[y0:y1, x0:x1]
            ch, cw = crop.shape[:2]
            pts01 = self.point_grids[layer_idx]
            n_pts = len(pts01)
            masks, ious, stab, _, keep, final = self._decode(crop, pts01)
            self.last_counts["candidates"] += int(keep.shape[0])
            self.last_counts["into_nms"] += int(keep.sum())
            idxs = torch.nonzero(final).reshape(-1).cpu().numpy()
            self.last_counts["kept"] += len(idxs)
            if len(idxs) == 0:
                continue
            ious_np = ious[idxs].cpu().numpy()
            stab_np = stab[idxs].cpu().numpy()
            pts_img = pts01[(idxs // m) % n_pts]
            seg_all = self._upscale(masks, idxs, (ch, cw))
            for j in range(len(idxs)):
                full = np.zeros((oh, ow), bool)
                full[y0:y1, x0:x1] = seg_all[j]
                if not full.any():
                    continue
                all_recs.append({
                    "segmentation": (full if self.output_mode == "binary_mask"
                                     else rle_mod.encode_mask(full)),
                    "area": int(np.count_nonzero(full)),
                    "bbox": _xywh(full),
                    "predicted_iou": float(ious_np[j]),
                    "point_coords": [(pts_img[j] * [cw, ch]
                                      + [x0, y0]).tolist()],
                    "stability_score": float(stab_np[j]),
                    "crop_box": list(crop_box),
                })

        if self.min_mask_region_area > 0:
            all_recs = self.postprocess_small_regions(all_recs)

        # cross-crop NMS (reference :243-249): the smaller crop wins
        if len(crop_boxes) > 1 and all_recs:
            boxes = torch.tensor([[r["bbox"][0], r["bbox"][1],
                                   r["bbox"][0] + r["bbox"][2],
                                   r["bbox"][1] + r["bbox"][3]]
                                  for r in all_recs], dtype=torch.float32)
            scores = torch.tensor(
                [1.0 / max(1e-6, np.prod(r["crop_box"][2:]))
                 for r in all_recs], dtype=torch.float32)
            kept = self._nms(boxes, scores,
                             torch.ones(len(all_recs), dtype=torch.bool),
                             self.crop_nms_thresh)
            all_recs = [r for r, k in zip(all_recs, kept.tolist()) if k]
        return all_recs

    @torch.no_grad()
    def postprocess_small_regions(self, recs):
        """Remove foreground sprinkles, then fill background holes, of at
        most `min_mask_region_area` pixels with the connected components on
        the device (reference amg.py:remove_small_regions and
        postprocess_small_regions :387-436); a mask left empty is dropped
        and box and area follow the new mask."""
        area_max = self.min_mask_region_area
        out = []
        for c0 in range(0, len(recs), _UPSCALE_CHUNK):
            part = recs[c0:c0 + _UPSCALE_CHUNK]
            binary = np.stack([
                r["segmentation"] if isinstance(r["segmentation"], np.ndarray)
                else rle_mod.decode_rle(r["segmentation"]).astype(bool)
                for r in part])
            m = torch.as_tensor(binary, device=self.device)
            labels, areas = connected_components(m)
            m = m & ~((labels > 0) & (areas <= area_max))
            labels, areas = connected_components(~m)
            m = m | ((labels > 0) & (areas <= area_max))
            for r, b in zip(part, m.cpu().numpy()):
                if not b.any():
                    continue
                r = dict(r)
                r["segmentation"] = (b if isinstance(r["segmentation"],
                                                     np.ndarray)
                                     else rle_mod.encode_mask(b))
                r["area"] = int(np.count_nonzero(b))
                r["bbox"] = _xywh(b)
                out.append(r)
        return out
