"""SAM2 assembly for the image path (port of
`no_time_to_train_tpu/models/sam2/model.py`; reference
sam2/modeling/sam2_base.py).

Holds the image encoder, the prompt encoder and the mask decoder under the
reference's state_dict names. The video-memory modules are not part of the
port yet.
"""
import torch.nn as nn

from no_time_to_train_tpu_torch.models.sam2.common import conv1x1
from no_time_to_train_tpu_torch.models.sam2.mask_decoder import MaskDecoder
from no_time_to_train_tpu_torch.models.sam2.neck import Sam2ImageEncoder
from no_time_to_train_tpu_torch.models.sam2.prompt_encoder import PromptEncoder

__all__ = ["SAM2"]


class SAM2(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        emb = cfg.sam_image_embedding_size
        self.image_encoder = Sam2ImageEncoder(cfg)
        self.sam_prompt_encoder = PromptEncoder(
            cfg.hidden_dim, (emb, emb), (cfg.image_size, cfg.image_size))
        self.sam_mask_decoder = MaskDecoder(
            cfg.hidden_dim, use_high_res_features=cfg.use_high_res_features_in_sam,
            iou_prediction_use_sigmoid=cfg.iou_prediction_use_sigmoid,
            pred_obj_scores=cfg.pred_obj_scores,
            pred_obj_scores_mlp=cfg.pred_obj_scores_mlp)

    def forward_image(self, imgs):
        """imgs [B, S, S, 3] normalized -> dict with `backbone_fpn` (levels
        highest resolution first, conv_s0 / conv_s1 applied to levels 0 and
        1 when the decoder uses high-resolution features)."""
        out = self.image_encoder(imgs)
        if self.cfg.use_high_res_features_in_sam:
            fpn = list(out["backbone_fpn"])
            dec = self.sam_mask_decoder
            fpn[0] = conv1x1(dec.conv_s0, fpn[0])
            fpn[1] = conv1x1(dec.conv_s1, fpn[1])
            out["backbone_fpn"] = fpn
        return out

    def forward_sam_heads_best(self, backbone_features, point_coords,
                               point_labels, high_res_features=None):
        """Grid decode: point prompts [B, 1, 2] / labels [B, 1] against one
        image's features [1, h, w, C]. Returns (mask [B, 4h, 4w] in the
        compute dtype, iou [B])."""
        pe = self.sam_prompt_encoder
        sparse = pe.embed_points(point_coords, point_labels)
        return self.sam_mask_decoder.predict_best_of_multimask(
            backbone_features, pe.get_dense_pe(), sparse, pe.no_mask_dense(),
            high_res_features=high_res_features)
