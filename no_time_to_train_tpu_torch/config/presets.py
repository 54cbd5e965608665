"""Model topology presets of the slice (copy of
`no_time_to_train_tpu/config/presets.py`, re-homed so the port never imports
the JAX package; tests/test_torch_convert.py holds the two equal).

`SAM2_PRESETS` is keyed by the reference's YAML names; `ENCODER_PRESETS`
holds the DINOv2 and DINOv3 encoders.
"""
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Sam2Config:
    # Hiera trunk
    embed_dim: int = 96
    num_heads: int = 1
    stages: Tuple[int, ...] = (2, 3, 16, 3)
    global_att_blocks: Tuple[int, ...] = (12, 16, 20)
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (14, 14)
    window_spec: Tuple[int, ...] = (8, 4, 14, 7)
    # FPN neck
    d_model: int = 256
    backbone_channel_list: Tuple[int, ...] = (768, 384, 192, 96)
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    fpn_interp_model: str = "nearest"
    scalp: int = 1
    # memory attention
    mem_attn_layers: int = 4
    mem_attn_dim_feedforward: int = 2048
    mem_dim: int = 64
    rope_feat_sizes: Tuple[int, int] = (32, 32)
    # memory encoder
    mem_enc_out_dim: int = 64
    # SAM2Base flags (sam2_configs/*.yaml:88-117)
    num_maskmem: int = 7
    image_size: int = 1024
    backbone_stride: int = 16
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    binarize_mask_from_pts_for_mem_enc: bool = True   # video-predictor override
    use_mask_input_as_output_without_sam: bool = True
    directly_add_no_mem_embed: bool = True
    use_high_res_features_in_sam: bool = True
    multimask_output_in_sam: bool = True
    multimask_min_pt_num: int = 0
    multimask_max_pt_num: int = 1
    multimask_output_for_tracking: bool = True
    use_multimask_token_for_obj_ptr: bool = True
    iou_prediction_use_sigmoid: bool = True
    memory_temporal_stride_for_eval: int = 1
    use_obj_ptrs_in_encoder: bool = True
    max_obj_ptrs_in_encoder: int = 16
    add_tpos_enc_to_obj_ptrs: bool = False
    proj_tpos_enc_in_obj_ptrs: bool = False
    only_obj_ptrs_in_the_past_for_eval: bool = True
    pred_obj_scores: bool = True
    pred_obj_scores_mlp: bool = True
    fixed_no_obj_ptr: bool = True
    soft_no_obj_ptr: bool = False
    use_mlp_for_obj_ptr_proj: bool = True
    # mask-decoder extras (build_sam.py:26-32 overrides)
    dynamic_multimask_via_stability: bool = True
    dynamic_multimask_stability_delta: float = 0.05
    dynamic_multimask_stability_thresh: float = 0.98
    fill_hole_area: int = 8                            # video-predictor override
    max_cond_frames_in_attn: int = -1
    non_overlap_masks_for_mem_enc: bool = False
    # whether correction clicks on an already-tracked frame promote it to a
    # conditioning frame (reference sam2_base.py:36 / :262)
    add_all_frames_to_correct_as_cond: bool = False

    @property
    def num_feature_levels(self):
        return 3 if self.use_high_res_features_in_sam else 1

    @property
    def sam_image_embedding_size(self):
        return self.image_size // self.backbone_stride

    @property
    def hidden_dim(self):
        return self.d_model


SAM2_PRESETS = {
    "sam2_hiera_t.yaml": Sam2Config(
        embed_dim=96, num_heads=1, stages=(1, 2, 7, 2),
        global_att_blocks=(5, 7, 9),
        window_pos_embed_bkg_spatial_size=(7, 7),
        backbone_channel_list=(768, 384, 192, 96)),
    "sam2_hiera_s.yaml": Sam2Config(
        embed_dim=96, num_heads=1, stages=(1, 2, 11, 2),
        global_att_blocks=(7, 10, 13),
        window_pos_embed_bkg_spatial_size=(7, 7),
        backbone_channel_list=(768, 384, 192, 96)),
    "sam2_hiera_b+.yaml": Sam2Config(
        embed_dim=112, num_heads=2, stages=(2, 3, 16, 3),
        global_att_blocks=(12, 16, 20),
        window_pos_embed_bkg_spatial_size=(14, 14),
        backbone_channel_list=(896, 448, 224, 112)),
    "sam2_hiera_l.yaml": Sam2Config(
        embed_dim=144, num_heads=2, stages=(2, 6, 36, 4),
        global_att_blocks=(23, 33, 43),
        window_pos_embed_bkg_spatial_size=(7, 7),
        window_spec=(8, 4, 16, 8),
        backbone_channel_list=(1152, 576, 288, 144)),
}


@dataclass(frozen=True)
class EncoderConfig:
    """DINOv2/v3 feature-extractor presets (reference
    Sam2MatchingBaseline_noAMG.py:26-126)."""
    name: str
    img_size: int
    patch_size: int
    feat_dim: int
    depth: int
    num_heads: int
    hf_model_name: str
    init_values: Optional[float] = 1e-5
    num_register_tokens: int = 0
    ffn_layer: str = "mlp"
    family: str = "dinov2"

    @property
    def grid_size(self):
        return self.img_size // self.patch_size


ENCODER_PRESETS = {
    "dinov2_small": EncoderConfig("dinov2_small", 518, 14, 384, 12, 6,
                                  "facebook/dinov2-small"),
    "dinov2_base": EncoderConfig("dinov2_base", 518, 14, 768, 12, 12,
                                 "facebook/dinov2-base"),
    "dinov2_large": EncoderConfig("dinov2_large", 518, 14, 1024, 24, 16,
                                  "facebook/dinov2-large"),
    "dinov2_giant": EncoderConfig("dinov2_giant", 518, 14, 1536, 40, 24,
                                  "facebook/dinov2-giant", ffn_layer="swiglu"),
    "dinov3_small": EncoderConfig("dinov3_small", 592, 16, 384, 12, 6,
                                  "facebook/dinov3-vits16-pretrain-lvd1689m",
                                  num_register_tokens=4, family="dinov3"),
    "dinov3_base": EncoderConfig("dinov3_base", 592, 16, 768, 12, 12,
                                 "facebook/dinov3-vitb16-pretrain-lvd1689m",
                                 num_register_tokens=4, family="dinov3"),
    "dinov3_large": EncoderConfig("dinov3_large", 592, 16, 1024, 24, 16,
                                  "facebook/dinov3-vitl16-pretrain-lvd1689m",
                                  num_register_tokens=4, family="dinov3"),
    "dinov3_huge": EncoderConfig("dinov3_huge", 592, 16, 1280, 32, 20,
                                 "facebook/dinov3-vith16plus-pretrain-lvd1689m",
                                 num_register_tokens=4, family="dinov3"),
}
