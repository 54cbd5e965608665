"""Matcher-flavoured automatic mask generator (port of
`no_time_to_train_tpu/models/matching/matcher_amg.py`; reference
no_time_to_train/models/matcher_utils.py:62-309).

Three modes beside the plain grid of `SAM2AutomaticMaskGenerator`:
  - select: caller-chosen point prompts (each point its own prompt), padded
    to a multiple of the chunk, with an optional box shared by all of them
    that rides as two corner points with labels 2 and 3 after the point,
    the embedding order of the reference's points + box prompt;
  - dense_pred: the grid's candidates that pass the filters, with no NMS
    (matcher_utils.py:135-140);
  - extra_mask_data: candidates of an earlier pass compete in the same NMS
    (:184-185).
The k-means++ of matcher_utils.py:30-57 is `memory_bank.kmeans_pp_init`.
"""
import numpy as np
import torch

from no_time_to_train_tpu_torch.models.sam2.amg import (
    SAM2AutomaticMaskGenerator)
from no_time_to_train_tpu_torch.models.sam2.image_predictor import (
    encode_image)

__all__ = ["SAM2AutomaticMaskGeneratorMatcher"]


class SAM2AutomaticMaskGeneratorMatcher(SAM2AutomaticMaskGenerator):
    """AMG with caller-selected prompts, dense_pred and extra_mask_data."""

    @torch.no_grad()
    def _decode_select(self, img, pts, labels, box, n_prompts):
        """img [H, W, 3] in [0, 1]; pts [P, n, 2] model pixels (P a multiple
        of the chunk); labels [P, n]; box [4] model-pixel XYXY or None.
        Returns per candidate (logits, iou, stability, boxes, keep before
        the NMS)."""
        fpn = encode_image(self.model, img)
        if box is not None:
            p_total = pts.shape[0]
            corners = box.reshape(1, 2, 2).expand(p_total, 2, 2)
            pts = torch.cat([pts, corners], dim=1)
            labels = torch.cat([labels, torch.tensor(
                [[2, 3]], device=self.device).expand(p_total, 2)], dim=1)
        masks, ious = self._decode_chunks(fpn, pts, labels)
        valid = torch.arange(masks.shape[0], device=self.device) \
            // self.masks_per_prompt < n_prompts
        keep, stab, boxes = self._filter(masks, ious, valid)
        return masks, ious, stab, boxes, keep

    def generate(self, image, select_point_coords=None,
                 select_point_labels=None, select_box=None,
                 select_mask_input=None, dense_pred=False,
                 extra_mask_data=None):
        """matcher_utils.py:63-84. In select mode returns (masks [K, H, W]
        bool at the original size, ious [K]); with `dense_pred` the pre-NMS
        candidate dict. `select_mask_input` is not implemented, as in the
        reference (:233-234)."""
        if select_mask_input is not None:
            raise NotImplementedError
        if dense_pred:
            if extra_mask_data is not None:
                raise ValueError("dense_pred takes no extra_mask_data")
            return self._generate_dense(image)
        if select_point_coords is None or select_point_labels is None:
            raise ValueError("select mode needs point coordinates and labels")
        oh, ow = image.shape[:2]
        s = self.model.cfg.image_size
        scale = np.asarray([s / ow, s / oh], np.float32)
        pts = np.concatenate([np.asarray(p, np.float32).reshape(-1, 1, 2)
                              for p in select_point_coords], axis=0) * scale
        labels = np.concatenate([np.asarray(lab).reshape(-1, 1)
                                 for lab in select_point_labels],
                                axis=0).astype(np.int64)
        n_prompts = pts.shape[0]
        chunk = min(self.points_per_batch, max(n_prompts, 1))
        pad = -n_prompts % chunk
        pts = np.pad(pts, ((0, pad), (0, 0), (0, 0)))
        labels = np.pad(labels, ((0, pad), (0, 0)))
        box = None
        if select_box is not None:
            box = np.asarray(select_box, np.float32).reshape(4) \
                * np.concatenate([scale, scale])
            box = torch.as_tensor(box, device=self.device)
        masks, ious, _, boxes, keep = self._decode_select(
            image, torch.as_tensor(pts, device=self.device),
            torch.as_tensor(labels, device=self.device), box, n_prompts)
        n_own = keep.shape[0]
        if extra_mask_data is not None:
            # earlier candidates compete in the same NMS (reference
            # :184-185); their boxes come at the original image's scale and
            # are brought to the low-resolution frame this pass scores in
            lr = masks.shape[-1]
            ex_boxes = torch.as_tensor(
                np.asarray(extra_mask_data["boxes"], np.float32)
                * np.asarray([lr / ow, lr / oh, lr / ow, lr / oh], np.float32),
                device=self.device)
            ex_ious = torch.as_tensor(
                np.asarray(extra_mask_data["iou_preds"], np.float32),
                device=self.device)
            boxes = torch.cat([boxes, ex_boxes])
            ious = torch.cat([ious, ex_ious])
            keep = torch.cat([keep, torch.ones_like(ex_ious,
                                                    dtype=torch.bool)])
        final = self._nms(boxes, ious, keep, self.box_nms_thresh).cpu().numpy()
        ious_np = ious.cpu().numpy()
        kept_own = np.nonzero(final[:n_own])[0]
        out_masks = list(self._upscale(masks, kept_own, (oh, ow)))
        out_ious = [float(ious_np[j]) for j in kept_own]
        if extra_mask_data is not None:
            ex_masks = np.asarray(extra_mask_data["masks"])
            for j in np.nonzero(final[n_own:])[0]:
                out_masks.append(np.asarray(ex_masks[j], bool))
                out_ious.append(float(ious_np[n_own + j]))
        masks_out = (np.stack(out_masks) if out_masks
                     else np.zeros((0, oh, ow), bool))
        return masks_out, np.asarray(out_ious, np.float32)

    def _generate_dense(self, image):
        """The grid's candidates after the filters, with no NMS
        (matcher_utils.py:135-140), as a MaskData-like dict at the original
        image's size."""
        oh, ow = image.shape[:2]
        pts01 = self.point_grids[0]
        masks, ious, stab, boxes, keep, _ = self._decode(image, pts01)
        idxs = torch.nonzero(keep).reshape(-1).cpu().numpy()
        lr = masks.shape[-1]
        box_scale = np.asarray([ow / lr, oh / lr, ow / lr, oh / lr],
                               np.float32)
        return {
            "masks": self._upscale(masks, idxs, (oh, ow)),
            "iou_preds": ious[idxs].cpu().numpy(),
            "stability_score": stab[idxs].cpu().numpy(),
            "boxes": boxes[idxs].cpu().numpy() * box_scale,
            "points": pts01[(idxs // self.masks_per_prompt) % len(pts01)]
            * np.asarray([ow, oh], np.float32),
        }
