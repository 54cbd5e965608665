"""Single-image predictor (port of
`no_time_to_train_tpu/models/sam2/image_predictor.py`; reference
sam2/sam2_image_predictor.py).

`set_image` runs Hiera + FPN once; `predict` runs the prompt encoder and
the classic mask decoder (`MaskDecoder.forward`) for point, box and mask
prompts, batched over the prompts. Logits are clamped to +-32 before the
resize, as the reference does (:434). Everything runs on the device and in
the dtype of the SAM2 module it is given.
"""
import numpy as np
import torch

from no_time_to_train_tpu_torch.models.matching.pipeline import (
    IMAGENET_MEAN, IMAGENET_STD)
from no_time_to_train_tpu_torch.ops.connected_components import (
    postprocess_masks_cc)
from no_time_to_train_tpu_torch.ops.resize import resize, resize_hw

__all__ = ["SAM2ImagePredictor", "encode_image"]


def _device_dtype(model):
    p = next(model.parameters())
    return p.device, p.dtype


@torch.no_grad()
def encode_image(model, image):
    """image [H, W, 3] float in [0, 1] (numpy or tensor, any size) ->
    the FPN levels of `model.forward_image` on the image resized to the
    model's resolution (bilinear) and normalized, highest resolution
    first."""
    dev, dt = _device_dtype(model)
    s = model.cfg.image_size
    img = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image)
                          else image, dtype=torch.float32, device=dev)
    x = resize(img[None], (s, s), mode="bilinear")
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    return model.forward_image(((x - mean) / std).to(dt))["backbone_fpn"]


class SAM2ImagePredictor:
    def __init__(self, model, mask_threshold=0.0, max_hole_area=0.0,
                 max_sprinkle_area=0.0):
        self.model = model
        self.device, self.dtype = _device_dtype(model)
        self.mask_threshold = mask_threshold
        self.max_hole_area = max_hole_area
        self.max_sprinkle_area = max_sprinkle_area
        self._features = None
        self._orig_hw = None

    def set_image(self, image):
        """image: [H, W, 3] float in [0, 1] (any size; resized to the
        model's resolution)."""
        self._orig_hw = tuple(image.shape[:2])
        self._features = encode_image(self.model, image)

    @torch.no_grad()
    def _predict_impl(self, coords, labels, boxes, mask_input,
                      multimask_output):
        fpn = self._features
        m = self.model
        hr = ([fpn[0], fpn[1]] if m.cfg.use_high_res_features_in_sam
              else None)
        pe = m.sam_prompt_encoder
        sparse, dense = pe(points=None if coords is None else (coords, labels),
                           boxes=boxes, masks=mask_input)
        masks, ious, _, _ = m.sam_mask_decoder(
            fpn[-1], pe.get_dense_pe(), sparse, dense, multimask_output,
            high_res_features=hr)
        return masks.float(), ious.float()

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def predict(self, point_coords=None, point_labels=None, box=None,
                mask_input=None, multimask_output=True, return_logits=False):
        """Prompts in the ORIGINAL image's pixel coordinates: points [N, 2]
        with labels [N] (one prompt), boxes [4] or [B, 4] (a batch of box
        prompts), a mask input [4h, 4w] or [B, 4h, 4w] of low-resolution
        logits. Returns (masks [B, M, H, W] bool, or float logits with
        `return_logits`; ious [B, M]; low-resolution logits [B, M, 4h, 4w])
        as numpy."""
        if self._features is None:
            raise RuntimeError("call set_image first")
        s = self.model.cfg.image_size
        oh, ow = self._orig_hw
        coords = labels = boxes = mi = None
        if point_coords is not None:
            c = np.asarray(point_coords, np.float32).reshape(-1, 2)
            coords = self._tensor(c * [s / ow, s / oh])[None]
            labels = self._tensor(np.asarray(point_labels).reshape(1, -1),
                                  torch.long)
        if box is not None:
            b = np.asarray(box, np.float32).reshape(-1, 4)
            boxes = self._tensor(b * [s / ow, s / oh, s / ow, s / oh])
        if mask_input is not None:
            mi = self._tensor(mask_input)[..., None]
            if mi.dim() == 3:
                mi = mi[None]
        lr, ious = self._predict_impl(coords, labels, boxes, mi,
                                      multimask_output)
        lr = lr.clamp(-32.0, 32.0)
        if self.max_hole_area > 0 or self.max_sprinkle_area > 0:
            lr = postprocess_masks_cc(lr, self.mask_threshold,
                                      self.max_hole_area,
                                      self.max_sprinkle_area)
        hi = resize_hw(lr, (oh, ow), mode="bilinear")
        if not return_logits:
            hi = hi > self.mask_threshold
        return hi.cpu().numpy(), ious.cpu().numpy(), lr.cpu().numpy()
