"""The port of `no_time_to_train_tpu/config/hydra_yaml.py`, on the port's own
YAML reader (`config/yaml_lite.py`).

Ingest reference hydra `sam2_configs/*.yaml` `_target_` trees.

The reference composes an arbitrary hydra config into live modules
(sam2/build_sam.py:34-36 `compose(config_name=...)` + `instantiate`). Here
the tree is *parsed* into a `Sam2Config` dataclass instead: the `_target_`
class names index a field-mapping table, so any user-supplied topology
variant (different dims, stages, window spec, memory geometry, behavior
flags) builds without belonging to the 4-entry preset dict. Known preset
basenames still short-circuit to `SAM2_PRESETS` (`resolve_sam2_cfg`).

Fields the port does not model (dropout at eval time, activation
strings already fixed by the architecture, `compile_image_encoder`) are
accepted and ignored; a truly unknown *model-level* flag raises so silent
topology mismatches cannot slip through.
"""
import dataclasses
import os

from no_time_to_train_tpu_torch.config import yaml_lite
from no_time_to_train_tpu_torch.config.presets import Sam2Config, SAM2_PRESETS


def _tup(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


# trunk (hieradet.Hiera) constructor args -> Sam2Config fields
_TRUNK_FIELDS = {
    "embed_dim": "embed_dim",
    "num_heads": "num_heads",
    "stages": "stages",
    "global_att_blocks": "global_att_blocks",
    "window_pos_embed_bkg_spatial_size": "window_pos_embed_bkg_spatial_size",
    "window_spec": "window_spec",
}

# neck (image_encoder.FpnNeck) args
_NECK_FIELDS = {
    "d_model": "d_model",
    "backbone_channel_list": "backbone_channel_list",
    "fpn_top_down_levels": "fpn_top_down_levels",
    "fpn_interp_model": "fpn_interp_model",
}

# SAM2Base flags present in the yaml model: section (sam2_configs/*.yaml)
_MODEL_FIELDS = {
    "num_maskmem", "image_size", "backbone_stride",
    "sigmoid_scale_for_mem_enc", "sigmoid_bias_for_mem_enc",
    "binarize_mask_from_pts_for_mem_enc",
    "use_mask_input_as_output_without_sam", "directly_add_no_mem_embed",
    "use_high_res_features_in_sam", "multimask_output_in_sam",
    "multimask_min_pt_num", "multimask_max_pt_num",
    "multimask_output_for_tracking", "use_multimask_token_for_obj_ptr",
    "iou_prediction_use_sigmoid", "memory_temporal_stride_for_eval",
    "use_obj_ptrs_in_encoder", "max_obj_ptrs_in_encoder",
    "add_tpos_enc_to_obj_ptrs", "proj_tpos_enc_in_obj_ptrs",
    "only_obj_ptrs_in_the_past_for_eval", "pred_obj_scores",
    "pred_obj_scores_mlp", "fixed_no_obj_ptr", "soft_no_obj_ptr",
    "use_mlp_for_obj_ptr_proj", "max_cond_frames_in_attn",
    "non_overlap_masks_for_mem_enc",
}

# accepted-and-ignored model-level keys (not modeled at eval time / fixed by
# the architecture)
_IGNORED_MODEL_KEYS = {"compile_image_encoder", "_target_",
                       "image_encoder", "memory_attention", "memory_encoder"}


def load_sam2_yaml(path):
    """Parse a reference-format SAM2 hydra YAML into a `Sam2Config`.

    Unspecified fields keep the `Sam2Config` defaults, which already bake in
    the reference's video-predictor behavioral overrides
    (build_sam.py:57-67) exactly like the presets do."""
    tree = yaml_lite.load_file(path)
    model = tree.get("model", tree)
    out = {}

    enc = model.get("image_encoder", {})
    if "scalp" in enc:
        out["scalp"] = int(enc["scalp"])
    for k, v in enc.get("trunk", {}).items():
        if k in _TRUNK_FIELDS:
            out[_TRUNK_FIELDS[k]] = _tup(v)
        elif k != "_target_":
            raise ValueError(f"unknown Hiera trunk key {k!r} in {path}")
    neck = enc.get("neck", {})
    for k, v in neck.items():
        if k in _NECK_FIELDS:
            out[_NECK_FIELDS[k]] = _tup(v)
        elif k not in ("_target_", "position_encoding"):
            raise ValueError(f"unknown FPN neck key {k!r} in {path}")

    mem_attn = model.get("memory_attention", {})
    if "num_layers" in mem_attn:
        out["mem_attn_layers"] = int(mem_attn["num_layers"])
    layer = mem_attn.get("layer", {})
    if "dim_feedforward" in layer:
        out["mem_attn_dim_feedforward"] = int(layer["dim_feedforward"])
    cross = layer.get("cross_attention", {})
    if "kv_in_dim" in cross:
        out["mem_dim"] = int(cross["kv_in_dim"])
    feat_sizes = layer.get("self_attention", {}).get("feat_sizes")
    if feat_sizes is not None:
        out["rope_feat_sizes"] = _tup(feat_sizes)

    mem_enc = model.get("memory_encoder", {})
    if "out_dim" in mem_enc:
        out["mem_enc_out_dim"] = int(mem_enc["out_dim"])

    for k, v in model.items():
        if k in _MODEL_FIELDS:
            out[k] = v
        elif k not in _IGNORED_MODEL_KEYS:
            raise ValueError(f"unknown SAM2Base key {k!r} in {path}")
    return dataclasses.replace(Sam2Config(), **out)


def resolve_sam2_cfg(sam2_cfg_file):
    """`sam2_cfg_file` -> `Sam2Config`: known preset basenames resolve from
    `SAM2_PRESETS` (reference behavior for the stock four topologies); any
    other value must be a readable hydra YAML on disk and is parsed
    (reference build_sam.py:34-36 accepts arbitrary config names)."""
    base = os.path.basename(str(sam2_cfg_file))
    if base in SAM2_PRESETS:
        return SAM2_PRESETS[base]
    if os.path.exists(str(sam2_cfg_file)):
        return load_sam2_yaml(sam2_cfg_file)
    raise KeyError(
        f"sam2_cfg_file {sam2_cfg_file!r}: not a known preset "
        f"({sorted(SAM2_PRESETS)}) and no such file on disk")
