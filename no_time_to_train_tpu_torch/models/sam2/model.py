"""SAM2 assembly (port of `no_time_to_train_tpu/models/sam2/model.py`;
reference sam2/modeling/sam2_base.py).

Holds the image encoder, the prompt encoder, the mask decoder and the
video-memory modules under the reference's state_dict names:
  - forward_image: Hiera + FPN (+ conv_s0 / conv_s1 on the two
    high-resolution levels);
  - forward_sam_heads_best: the grid decode of the matching pipeline;
  - forward_sam_heads: prompt encoder + mask decoder with the object
    pointer (sam2_base.py:251-455);
  - encode_memory / memory_conditioned_features / no_mem_features: the
    video-memory path (sam2_base.py:539-760).
Image tensors are NHWC; mask logits [B, M, H, W].
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from no_time_to_train_tpu_torch.models.sam2.common import MLP, conv1x1
from no_time_to_train_tpu_torch.models.sam2.mask_decoder import MaskDecoder
from no_time_to_train_tpu_torch.models.sam2.memory_attention import (
    MemoryAttention)
from no_time_to_train_tpu_torch.models.sam2.memory_encoder import MemoryEncoder
from no_time_to_train_tpu_torch.models.sam2.neck import Sam2ImageEncoder
from no_time_to_train_tpu_torch.models.sam2.prompt_encoder import PromptEncoder
from no_time_to_train_tpu_torch.ops.resize import resize_hw

__all__ = ["SAM2", "NO_OBJ_SCORE"]

NO_OBJ_SCORE = -1024.0


class SAM2(nn.Module):
    def __init__(self, cfg, encoder_quant="none"):
        """`encoder_quant="int8"`: W8A8 GEMMs in the image encoder's trunk
        only (ops/quant.py); the neck, the prompt and mask towers stay in the
        compute dtype, as in the JAX package."""
        super().__init__()
        self.cfg = c = cfg
        emb = c.sam_image_embedding_size
        self.image_encoder = Sam2ImageEncoder(c, quant=encoder_quant)
        self.sam_prompt_encoder = PromptEncoder(
            c.hidden_dim, (emb, emb), (c.image_size, c.image_size))
        self.sam_mask_decoder = MaskDecoder(
            c.hidden_dim, use_high_res_features=c.use_high_res_features_in_sam,
            iou_prediction_use_sigmoid=c.iou_prediction_use_sigmoid,
            pred_obj_scores=c.pred_obj_scores,
            pred_obj_scores_mlp=c.pred_obj_scores_mlp,
            dynamic_multimask_via_stability=c.dynamic_multimask_via_stability,
            dynamic_multimask_stability_delta=(
                c.dynamic_multimask_stability_delta),
            dynamic_multimask_stability_thresh=(
                c.dynamic_multimask_stability_thresh),
            use_multimask_token_for_obj_ptr=c.use_multimask_token_for_obj_ptr)
        self.memory_encoder = MemoryEncoder(
            out_dim=c.mem_enc_out_dim, in_dim=c.d_model, pos_num_feats=64,
            mask_downsampler_kwargs=dict(kernel_size=3, stride=2, padding=1))
        self.memory_attention = MemoryAttention(
            d_model=c.d_model, num_layers=c.mem_attn_layers,
            pos_enc_at_input=True,
            layer_kwargs=dict(dim_feedforward=c.mem_attn_dim_feedforward,
                              cross_kv_in_dim=c.mem_dim,
                              rope_feat_sizes=c.rope_feat_sizes))
        self.maskmem_tpos_enc = nn.Parameter(
            torch.zeros(c.num_maskmem, 1, 1, c.mem_dim))
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, c.hidden_dim))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, c.hidden_dim))
        if c.pred_obj_scores and c.use_obj_ptrs_in_encoder:
            self.no_obj_ptr = nn.Parameter(torch.zeros(1, c.hidden_dim))
        if c.use_obj_ptrs_in_encoder:
            self.obj_ptr_proj = (
                MLP(c.hidden_dim, c.hidden_dim, c.hidden_dim, 3)
                if c.use_mlp_for_obj_ptr_proj
                else nn.Linear(c.hidden_dim, c.hidden_dim))
            self.mask_downsample = nn.Conv2d(1, 1, 4, stride=4)

    # ------------------------------------------------------------------ image
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

    # ------------------------------------------------------------------ heads
    def forward_sam_heads_best(self, backbone_features, point_coords,
                               point_labels, high_res_features=None):
        """Grid decode: point prompts [B, 1, 2] / labels [B, 1] against the
        features [Bi, h, w, C] of Bi images (high_res_features with Bi rows
        too); every image is decoded at every prompt. Returns (mask
        [Bi * B, 4h, 4w] in the compute dtype, iou [Bi * B]), image-major."""
        pe = self.sam_prompt_encoder
        sparse = pe.embed_points(point_coords, point_labels)
        sparse = sparse.repeat(backbone_features.shape[0], 1, 1)
        return self.sam_mask_decoder.predict_best_of_multimask(
            backbone_features, pe.get_dense_pe(), sparse, pe.no_mask_dense(),
            high_res_features=high_res_features)

    def forward_sam_heads(self, backbone_features, point_coords=None,
                          point_labels=None, mask_inputs=None,
                          high_res_features=None, multimask_output=False,
                          output_all_masks=False):
        """backbone_features [B or 1, h, w, C]; point_coords [B, P, 2];
        point_labels [B, P]; mask_inputs [B, 4h, 4w, 1], already at the
        prompt encoder's mask size. Returns (low-res masks [B, 1, 4h, 4w]
        float32, high-res masks [B, 1, S, S], ious, object pointer [B, C],
        object score logits [B, 1]); with `output_all_masks` the decoder's
        four masks, ious, tokens and object score logits."""
        c = self.cfg
        if point_coords is None:
            dev = backbone_features.device
            b = (backbone_features if mask_inputs is None
                 else mask_inputs).shape[0]
            point_coords = torch.zeros((b, 1, 2), device=dev)
            point_labels = -torch.ones((b, 1), dtype=torch.long, device=dev)
        pe = self.sam_prompt_encoder
        sparse, dense = pe(points=(point_coords, point_labels),
                           masks=mask_inputs)
        low_res_multimasks, ious, sam_output_tokens, object_score_logits = (
            self.sam_mask_decoder(
                backbone_features, pe.get_dense_pe(), sparse, dense,
                multimask_output, high_res_features=high_res_features,
                output_all_masks=output_all_masks))
        if c.pred_obj_scores and not output_all_masks:
            is_obj = object_score_logits > 0
            low_res_multimasks = torch.where(
                is_obj[:, :, None, None], low_res_multimasks,
                torch.full_like(low_res_multimasks, NO_OBJ_SCORE))
        low_res_multimasks = low_res_multimasks.float()
        if output_all_masks:
            return (low_res_multimasks, ious, sam_output_tokens,
                    object_score_logits)

        if multimask_output:
            best = torch.argmax(ious, dim=-1)
            bi = torch.arange(best.shape[0], device=best.device)
            low_res_masks = low_res_multimasks[bi, best][:, None]
            sam_output_token = (sam_output_tokens[bi, best]
                                if sam_output_tokens.shape[1] > 1
                                else sam_output_tokens[:, 0])
        else:
            low_res_masks = low_res_multimasks
            sam_output_token = sam_output_tokens[:, 0]

        high_res_masks = resize_hw(low_res_masks, (c.image_size, c.image_size),
                                   mode="bilinear")
        obj_ptr = self.obj_ptr_proj(sam_output_token)
        if c.pred_obj_scores:
            lam = (torch.sigmoid(object_score_logits) if c.soft_no_obj_ptr
                   else (object_score_logits > 0).to(obj_ptr.dtype))
            if c.fixed_no_obj_ptr:
                obj_ptr = lam * obj_ptr
            obj_ptr = obj_ptr + (1.0 - lam) * self.no_obj_ptr
        return (low_res_masks, high_res_masks, ious, obj_ptr,
                object_score_logits)

    def downsample_mask(self, masks):
        """The 4x4 stride-4 `mask_downsample` convolution on [B, H, W, 1]."""
        conv = self.mask_downsample
        x = masks.to(conv.weight.dtype).permute(0, 3, 1, 2)
        return F.conv2d(x, conv.weight, conv.bias,
                        stride=conv.stride).permute(0, 2, 3, 1)

    # ----------------------------------------------------------------- memory
    def encode_memory(self, pix_feat, pred_masks_high_res, is_mask_from_pts,
                      force_binarize=False):
        """pix_feat [B, h, w, C]; masks [B, S, S, 1] logits at the image
        resolution. Returns (memory features, their position encoding),
        both [B, h, w, mem_dim] (sam2_base.py:718-760)."""
        c = self.cfg
        dt = self.no_mem_embed.dtype
        binarize = c.binarize_mask_from_pts_for_mem_enc and is_mask_from_pts
        if force_binarize or binarize:
            mask_for_mem = (pred_masks_high_res > 0).to(dt)
        else:
            mask_for_mem = torch.sigmoid(pred_masks_high_res)
        mask_for_mem = (mask_for_mem * c.sigmoid_scale_for_mem_enc
                        + c.sigmoid_bias_for_mem_enc)
        return self.memory_encoder(pix_feat, mask_for_mem,
                                   skip_mask_sigmoid=True)

    def memory_conditioned_features(self, curr_feat, curr_pos, memory,
                                    memory_pos, num_obj_ptr_tokens=0,
                                    memory_valid=None):
        """Memory attention: curr_feat / curr_pos [B, N, C], memory /
        memory_pos [B, M, mem_dim]; memory_valid [B, M] bool masks the
        padded slots of the fixed-shape bank."""
        return self.memory_attention(curr_feat, curr_pos, memory, memory_pos,
                                     num_obj_ptr_tokens=num_obj_ptr_tokens,
                                     memory_valid=memory_valid)

    def no_mem_features(self, curr_feat):
        """The directly_add_no_mem_embed path (sam2_base.py:685-689)."""
        return curr_feat + self.no_mem_embed.reshape(-1).to(curr_feat.dtype)
