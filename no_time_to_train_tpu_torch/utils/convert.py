"""JAX package parameter trees -> the port's state_dicts, and back for the
SAM2Ref head.

The inverse of `no_time_to_train_tpu/utils/torch_convert.py` (`convert_sam2` and its
parts),
`no_time_to_train_tpu/models/dino.convert_hf_dinov2` and
`no_time_to_train_tpu/models/dino_v3.convert_hf_dinov3`: given the numpy
leaves of `NoAMGMatcher.sam2_params` / `.dino_params`, build reference-named
state_dicts so that the port computes what the JAX package computes.
`sam2ref_heads_state_dict` carries the SAM2Ref head tree (`SAM2Ref.head_params`
of the JAX package, the pickle either package's trainer writes) into the
port's `RefHeads`; `sam2ref_heads_params` carries it back.

Layout rules (inverse of the JAX converters): Dense kernel [in, out] ->
Linear weight [out, in]; Conv HWIO -> OIHW; spatial embeddings HWC -> NCHW.
"""
import numpy as np

__all__ = ["sam2_state_dict", "dino_state_dict", "dino_v3_state_dict",
           "sam2ref_heads_state_dict", "sam2ref_heads_params"]


def _a(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _lin(sd, p, t):
    sd[f"{p}.weight"] = _a(np.asarray(t["kernel"]).T)
    if "bias" in t:
        sd[f"{p}.bias"] = _a(t["bias"])


def _conv(sd, p, t):
    sd[f"{p}.weight"] = _a(np.asarray(t["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in t:
        sd[f"{p}.bias"] = _a(t["bias"])


def _ln(sd, p, t):
    sd[f"{p}.weight"] = _a(t["weight"])
    sd[f"{p}.bias"] = _a(t["bias"])


def _mlp(sd, p, t):
    for name, sub in t.items():                     # layers_{i}
        _lin(sd, f"{p}.layers.{name.split('_')[1]}", sub)


def _image_encoder(sd, t):
    tr = t["trunk"]
    _conv(sd, "image_encoder.trunk.patch_embed.proj", tr["patch_embed"])
    sd["image_encoder.trunk.pos_embed"] = _a(
        np.asarray(tr["pos_embed"]).transpose(2, 0, 1)[None])
    sd["image_encoder.trunk.pos_embed_window"] = _a(
        np.asarray(tr["pos_embed_window"]).transpose(2, 0, 1)[None])
    for name, blk in tr.items():
        if not name.startswith("blocks_"):
            continue
        b = f"image_encoder.trunk.blocks.{name.split('_')[1]}"
        _ln(sd, f"{b}.norm1", blk["norm1"])
        _ln(sd, f"{b}.norm2", blk["norm2"])
        _lin(sd, f"{b}.attn.qkv", blk["attn"]["qkv"])
        _lin(sd, f"{b}.attn.proj", blk["attn"]["proj"])
        _mlp(sd, f"{b}.mlp", blk["mlp"])
        if "proj" in blk:
            _lin(sd, f"{b}.proj", blk["proj"])
    for name, conv in t["neck"].items():            # convs_{i}
        _conv(sd, f"image_encoder.neck.convs.{name.split('_')[1]}.conv", conv)


def _prompt_encoder(sd, t):
    p = "sam_prompt_encoder"
    sd[f"{p}.pe_layer.positional_encoding_gaussian_matrix"] = _a(t["pe_gaussian"])
    pts = np.asarray(t["point_embeddings"])
    for i in range(pts.shape[0]):
        sd[f"{p}.point_embeddings.{i}.weight"] = _a(pts[i:i + 1])
    sd[f"{p}.not_a_point_embed.weight"] = _a(t["not_a_point_embed"])
    sd[f"{p}.no_mask_embed.weight"] = _a(t["no_mask_embed"])
    for i in (0, 3, 6):
        _conv(sd, f"{p}.mask_downscaling.{i}", t[f"mask_downscaling_{i}"])
    for i in (1, 4):
        _ln(sd, f"{p}.mask_downscaling.{i}", t[f"mask_downscaling_{i}"])


def _attn(sd, p, t):
    for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _lin(sd, f"{p}.{k}", t[k])


def _mask_decoder(sd, t):
    p = "sam_mask_decoder"
    tr = t["transformer"]
    for name, lt in tr.items():
        if name.startswith("layers_"):
            lp = f"{p}.transformer.layers.{name.split('_')[1]}"
            for a in ("self_attn", "cross_attn_token_to_image",
                      "cross_attn_image_to_token"):
                _attn(sd, f"{lp}.{a}", lt[a])
            _mlp(sd, f"{lp}.mlp", lt["mlp"])
            for nrm in ("norm1", "norm2", "norm3", "norm4"):
                _ln(sd, f"{lp}.{nrm}", lt[nrm])
    _attn(sd, f"{p}.transformer.final_attn_token_to_image",
          tr["final_attn_token_to_image"])
    _ln(sd, f"{p}.transformer.norm_final_attn", tr["norm_final_attn"])
    sd[f"{p}.iou_token.weight"] = _a(t["iou_token"])
    sd[f"{p}.mask_tokens.weight"] = _a(t["mask_tokens"])
    sd[f"{p}.output_upscaling.0.weight"] = _a(t["output_upscaling_0_weight"])
    sd[f"{p}.output_upscaling.0.bias"] = _a(t["output_upscaling_0_bias"])
    _ln(sd, f"{p}.output_upscaling.1", t["output_upscaling_1"])
    sd[f"{p}.output_upscaling.3.weight"] = _a(t["output_upscaling_3_weight"])
    sd[f"{p}.output_upscaling.3.bias"] = _a(t["output_upscaling_3_bias"])
    _mlp(sd, f"{p}.iou_prediction_head", t["iou_prediction_head"])
    for name, sub in t.items():
        if name.startswith("output_hypernetworks_mlps_"):
            _mlp(sd, f"{p}.output_hypernetworks_mlps.{name.rsplit('_', 1)[1]}",
                 sub)
    if "obj_score_token" in t:
        sd[f"{p}.obj_score_token.weight"] = _a(t["obj_score_token"])
    if "pred_obj_score_head" in t:
        head = t["pred_obj_score_head"]
        if "kernel" in head:
            _lin(sd, f"{p}.pred_obj_score_head", head)
        else:
            _mlp(sd, f"{p}.pred_obj_score_head", head)
    elif "obj_score_token" in t:
        # the JAX decoder never calls its (dead, reference-faithful) object
        # score head, so its init creates no parameters for it; the port
        # holds the MLP head of the reference checkpoints, here as zeros
        d = np.asarray(t["iou_token"]).shape[-1]
        for i, (o, n) in enumerate(((d, d), (d, d), (1, d))):
            sd[f"{p}.pred_obj_score_head.layers.{i}.weight"] = np.zeros((o, n), np.float32)
            sd[f"{p}.pred_obj_score_head.layers.{i}.bias"] = np.zeros(o, np.float32)
    for k in ("conv_s0", "conv_s1"):
        if k in t:
            _conv(sd, f"{p}.{k}", t[k])


def _memory_encoder(sd, t):
    p = "memory_encoder"
    for name, sub in t["mask_downsampler"].items():     # encoder_{i}
        q = f"{p}.mask_downsampler.encoder.{name.split('_')[1]}"
        (_conv if "kernel" in sub else _ln)(sd, q, sub)
    _conv(sd, f"{p}.pix_feat_proj", t["pix_feat_proj"])
    for name, blk in t["fuser"].items():                # layers_{i}
        q = f"{p}.fuser.layers.{name.split('_')[1]}"
        _conv(sd, f"{q}.dwconv", blk["dwconv"])
        _ln(sd, f"{q}.norm", blk["norm"])
        _lin(sd, f"{q}.pwconv1", blk["pwconv1"])
        _lin(sd, f"{q}.pwconv2", blk["pwconv2"])
        sd[f"{q}.gamma"] = _a(blk["gamma"])
    if "out_proj" in t:
        _conv(sd, f"{p}.out_proj", t["out_proj"])


def _memory_attention(sd, t):
    p = "memory_attention"
    for name, lt in t.items():
        if not name.startswith("layers_"):
            continue
        q = f"{p}.layers.{name.split('_')[1]}"
        _attn(sd, f"{q}.self_attn", lt["self_attn"])
        _attn(sd, f"{q}.cross_attn_image", lt["cross_attn_image"])
        _lin(sd, f"{q}.linear1", lt["linear1"])
        _lin(sd, f"{q}.linear2", lt["linear2"])
        for nrm in ("norm1", "norm2", "norm3"):
            _ln(sd, f"{q}.{nrm}", lt[nrm])
    _ln(sd, f"{p}.norm", t["norm"])


def sam2_state_dict(params):
    """SAM2 flax params -> state_dict of the port's `SAM2`: image encoder,
    prompt encoder, mask decoder, memory encoder, memory attention and the
    video-memory parameters, under the reference's names and shapes."""
    sd = {}
    _image_encoder(sd, params["image_encoder"])
    _prompt_encoder(sd, params["sam_prompt_encoder"])
    _mask_decoder(sd, params["sam_mask_decoder"])
    _memory_encoder(sd, params["memory_encoder"])
    _memory_attention(sd, params["memory_attention"])
    sd["maskmem_tpos_enc"] = _a(
        np.asarray(params["maskmem_tpos_enc"])[:, None, None, :])
    sd["no_mem_embed"] = _a(np.asarray(params["no_mem_embed"])[None, None])
    sd["no_mem_pos_enc"] = _a(np.asarray(params["no_mem_pos_enc"])[None, None])
    if "no_obj_ptr" in params:
        sd["no_obj_ptr"] = _a(np.asarray(params["no_obj_ptr"])[None])
    if "obj_ptr_proj" in params:
        head = params["obj_ptr_proj"]
        (_lin if "kernel" in head else _mlp)(sd, "obj_ptr_proj", head)
    if "mask_downsample" in params:
        _conv(sd, "mask_downsample", params["mask_downsample"])
    return sd


def sam2ref_heads_state_dict(head_params):
    """The JAX package's SAM2Ref head tree (`SAM2Ref.head_params`, numpy
    leaves; the pickle its trainer writes) -> state_dict of the port's
    `RefHeads`."""
    sd = {"mem_feat_ref_pe.weight":
          _a(np.asarray(head_params["mem_feat_ref_pe"])[None]),
          "iou_embed.weight": _a(head_params["iou_embed"])}
    _mlp(sd, "iou_prediction_head", head_params["iou_prediction_head"])
    return sd


def sam2ref_heads_params(state_dict):
    """The inverse of `sam2ref_heads_state_dict`: `RefHeads`' state_dict
    (torch or numpy values) -> the JAX head tree with numpy leaves."""
    sd = {k: _a(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
          for k, v in state_dict.items()}
    prefix = "iou_prediction_head.layers."
    n_layers = 1 + max(int(k[len(prefix):].split(".")[0])
                       for k in sd if k.startswith(prefix))
    return {"mem_feat_ref_pe": sd["mem_feat_ref_pe.weight"][0],
            "iou_embed": sd["iou_embed.weight"],
            "iou_prediction_head": {
                f"layers_{i}": {
                    "kernel": _a(sd[f"{prefix}{i}.weight"].T),
                    "bias": sd[f"{prefix}{i}.bias"]}
                for i in range(n_layers)}}


def dino_state_dict(params, cfg):
    """DinoV2 flax params -> HF `Dinov2Model` state_dict (the unused
    mask_token is zero)."""
    d = cfg.feat_dim
    sd = {
        "embeddings.cls_token": _a(np.asarray(params["cls_token"])[None]),
        "embeddings.mask_token": np.zeros((1, d), np.float32),
        "embeddings.position_embeddings":
            _a(np.asarray(params["position_embeddings"])[None]),
    }
    _conv(sd, "embeddings.patch_embeddings.projection",
          params["patch_embeddings"])
    _ln(sd, "layernorm", params["layernorm"])
    for i in range(cfg.depth):
        t = params[f"layer_{i}"]
        p = f"encoder.layer.{i}"
        _ln(sd, f"{p}.norm1", t["norm1"])
        _ln(sd, f"{p}.norm2", t["norm2"])
        a = t["attention"]
        for k in ("query", "key", "value"):
            _lin(sd, f"{p}.attention.attention.{k}", a[k])
        _lin(sd, f"{p}.attention.output.dense", a["output"])
        if "layer_scale1" in t:                # absent without init_values
            sd[f"{p}.layer_scale1.lambda1"] = _a(t["layer_scale1"])
            sd[f"{p}.layer_scale2.lambda1"] = _a(t["layer_scale2"])
        for name, sub in t["mlp"].items():     # fc1 / fc2, or the SwiGLU's
            _lin(sd, f"{p}.mlp.{name}", sub)   # weights_in / weights_out
    return sd


def dino_v3_state_dict(params, cfg):
    """DinoV3 flax params -> HF `DINOv3ViTModel` state_dict (the unused
    mask_token is zero); the gated MLP where the params hold `mlp_gate`."""
    d = cfg.feat_dim
    sd = {
        "embeddings.cls_token": _a(np.asarray(params["cls_token"])[None]),
        "embeddings.mask_token": np.zeros((1, 1, d), np.float32),
        "embeddings.register_tokens":
            _a(np.asarray(params["register_tokens"])[None]),
    }
    _conv(sd, "embeddings.patch_embeddings", params["patch_embeddings"])
    _ln(sd, "norm", params["norm"])
    for i in range(cfg.depth):
        t = params[f"layer_{i}"]
        p = f"layer.{i}"
        _ln(sd, f"{p}.norm1", t["norm1"])
        _ln(sd, f"{p}.norm2", t["norm2"])
        for k in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _lin(sd, f"{p}.attention.{k}", t["attention"][k])
        sd[f"{p}.layer_scale1.lambda1"] = _a(t["layer_scale1"])
        sd[f"{p}.layer_scale2.lambda1"] = _a(t["layer_scale2"])
        for ours, theirs in (("mlp_gate", "gate_proj"), ("mlp_up", "up_proj"),
                             ("mlp_down", "down_proj")):
            if ours in t:
                _lin(sd, f"{p}.mlp.{theirs}", t[ours])
    return sd
