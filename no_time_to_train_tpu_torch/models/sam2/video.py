"""SAM2 video predictor (port of `no_time_to_train_tpu/models/sam2/video.py`;
reference sam2/sam2_video_predictor.py).

Host-side control flow (conditioning-frame selection, the memory ring,
correction clicks) around plain methods that run on the predictor's device
under `torch.no_grad()`:
  - `_features`: Hiera + FPN for one frame, with a one-frame cache;
  - `_cond`: a prompted frame without memory (directly_add_no_mem_embed);
  - `_track_core`: memory attention over a fixed-layout memory bank
    [maskmem rows | object-pointer tokens] with validity masks (padded
    slots are masked in the cross-attention, so the result is that of the
    reference's concatenation of a varying number of rows), the SAM heads,
    the memory encoder on the predicted masks and the hole filling;
  - `_encode`: the memory encoder.
Objects are batched along the leading axis of every step. Tracked frames'
outputs stay on the device; `propagate_in_video` yields device tensors and
never waits for them.

`propagate_in_video` tracks each maximal run of non-prompted frames by the
chunked scan (`scan_chunk` frames a chunk, default 8; 0 tracks frame by
frame): `_scan_step`, the body of the JAX package's `lax.scan`, tracks one
frame from a frame id held on the device, with the memory in rings indexed
by frame id, and `_scan_plan` runs it over the run. On a CUDA device the
step is captured once in a CUDA graph per shape and branch (objects,
conditioning rows and pointers, direction, ...) and each frame is one
replay, so the host issues a frame copy and a graph launch a frame instead
of some 1500 launches; on the CPU the same step runs eagerly. A failed
capture raises. The JAX package's own conditions (a clip on the host, more
conditioning frames than `max_cond_frames_in_attn`, one-frame runs,
`history_window = 0`) send a run down the per-frame path.
"""
import time
import warnings
from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import torch

from no_time_to_train_tpu_torch.models.matching.pipeline import (
    IMAGENET_MEAN, IMAGENET_STD)
from no_time_to_train_tpu_torch.models.sam2.model import NO_OBJ_SCORE
from no_time_to_train_tpu_torch.models.sam2.pos_enc import sine_pos_embed_2d
from no_time_to_train_tpu_torch.ops.connected_components import (
    fill_holes_in_mask_scores)
from no_time_to_train_tpu_torch.ops.graph_inputs import holding
from no_time_to_train_tpu_torch.ops.resize import resize_hw
from no_time_to_train_tpu_torch.ops.upscale_product import fusion_disabled

__all__ = ["SAM2VideoPredictor", "apply_non_overlapping_constraints",
           "select_closest_cond_frames"]

# captured scan steps kept per predictor; each holds a CUDA graph and its
# private memory pool (PERF.md gives the pool's size at SAM2-L)
_SCAN_GRAPHS = 2


def apply_non_overlapping_constraints(pred_masks):
    """Keep only the highest-scoring object at each pixel and push the
    others to <= -10 (reference sam2_base.py:869-887). pred_masks
    [..., B, H, W], objects on axis -3."""
    if pred_masks.shape[-3] == 1:
        return pred_masks
    max_obj = torch.argmax(pred_masks, dim=-3, keepdim=True)
    batch_obj = torch.arange(pred_masks.shape[-3],
                             device=pred_masks.device)[:, None, None]
    return torch.where(max_obj == batch_obj, pred_masks,
                       torch.clamp(pred_masks, max=-10.0))


def select_closest_cond_frames(frame_idx, cond_frame_outputs,
                               max_cond_frame_num):
    """Reference sam2_utils.select_closest_cond_frames (:15-57)."""
    if max_cond_frame_num == -1 \
            or len(cond_frame_outputs) <= max_cond_frame_num:
        return dict(cond_frame_outputs), {}
    assert max_cond_frame_num >= 2
    selected = {}
    idx_before = max((t for t in cond_frame_outputs if t < frame_idx),
                     default=None)
    if idx_before is not None:
        selected[idx_before] = cond_frame_outputs[idx_before]
    idx_after = min((t for t in cond_frame_outputs if t >= frame_idx),
                    default=None)
    if idx_after is not None:
        selected[idx_after] = cond_frame_outputs[idx_after]
    remain = sorted((t for t in cond_frame_outputs if t not in selected),
                    key=lambda x: abs(x - frame_idx))
    for t in remain[: max_cond_frame_num - len(selected)]:
        selected[t] = cond_frame_outputs[t]
    unselected = {t: v for t, v in cond_frame_outputs.items()
                  if t not in selected}
    return selected, unselected


class SAM2VideoPredictor:
    """model: a `SAM2` with its weights loaded; it is moved to `device` and
    keeps its dtype."""

    def __init__(self, model, *, device,
                 clear_non_cond_mem_around_input=False,
                 clear_non_cond_mem_for_multi_obj=False,
                 non_overlap_masks=False):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.cfg = c = model.cfg
        self.dtype = model.no_mem_embed.dtype
        # correction-click memory hygiene (reference
        # sam2_video_predictor.py:21-37)
        self.clear_non_cond_mem_around_input = clear_non_cond_mem_around_input
        self.clear_non_cond_mem_for_multi_obj = clear_non_cond_mem_for_multi_obj
        # cross-object non-overlap on the final video-resolution outputs
        self.non_overlap_masks = non_overlap_masks
        self._feat_hw = c.sam_image_embedding_size
        self._n_feat = self._feat_hw * self._feat_hw
        # Entries farther than this many frames from the one being tracked
        # can never be selected again (the maskmem lookback is
        # (num_maskmem - 2) * stride + 2, the pointer lookback
        # max_obj_ptrs), so they are dropped; 0 keeps everything.
        r = max(c.memory_temporal_stride_for_eval, 1)
        self.history_window = max((c.num_maskmem - 2) * r + 2,
                                  c.max_obj_ptrs_in_encoder,
                                  c.num_maskmem) + 1
        # frames a chunk of the chunked scan (`_scan_plan`); 0 tracks every
        # run frame by frame
        self.scan_chunk = 8
        # maskmem ring of the scan: one slot more than the farthest strided
        # lookback ((num_maskmem - 2) * stride + 1)
        self._ring_W = max((c.num_maskmem - 2) * r + 2, 2)
        # scan steps by key (`_scan_key`), least recently used first
        self._scan_steps = OrderedDict()
        # captures by key, replays, and each capture's seconds and pool bytes
        self.scan_stats = {"captures": {}, "replays": 0, "capture_s": {},
                           "pool_bytes": {}}
        dev, f32 = self.device, torch.float32
        self._mean = torch.as_tensor(IMAGENET_MEAN, dtype=f32, device=dev)
        self._std = torch.as_tensor(IMAGENET_STD, dtype=f32, device=dev)
        self._zero_tok = torch.zeros((self._n_feat, c.mem_dim), dtype=f32,
                                     device=dev)
        self._zero_ptr = torch.zeros((c.hidden_dim,), dtype=f32, device=dev)
        self._tpos = model.maskmem_tpos_enc.detach().reshape(
            c.num_maskmem, c.mem_dim).float()
        # position encoding of the lowest FPN level, [1, n_feat, d_model]
        self._feat_pos = sine_pos_embed_2d(
            self._feat_hw, self._feat_hw, c.d_model, dtype=self.dtype,
            device=dev).reshape(1, self._n_feat, c.d_model)

    def _dev(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # ---------------------------------------------------------- device steps
    @torch.no_grad()
    def _features(self, img):
        """img [S, S, 3] in [0, 1] on the device -> FPN levels."""
        x = ((img.float() - self._mean) / self._std)[None].to(self.dtype)
        return self.model.forward_image(x)["backbone_fpn"]

    def _high_res(self, fpn):
        return ([fpn[0], fpn[1]] if self.cfg.use_high_res_features_in_sam
                else None)

    @torch.no_grad()
    def _cond(self, fpn, coords, labels, mask_in, multimask):
        """A prompted conditioning frame: no-memory embedding + SAM heads.
        The frame's features keep a batch of 1 under every object."""
        feats = fpn[-1]
        flat = self.model.no_mem_features(
            feats.reshape(1, self._n_feat, self.cfg.d_model))
        return self.model.forward_sam_heads(
            flat.reshape(feats.shape), coords, labels, mask_in,
            self._high_res(fpn), multimask)

    @torch.no_grad()
    def _track_heads(self, fpn, memory, memory_pos, memory_valid, multimask,
                     coords=None, labels=None, mask_in=None):
        """Memory-conditioned SAM heads. Prompts are None while tracking; a
        correction (clicks on a frame that was tracked already, reference
        sam2_video_predictor.py:262-301) passes the new clicks and the
        previous mask logits as the dense prompt (sam2_base.py:804-826 with
        is_init_cond_frame=False)."""
        c = self.cfg
        b = memory.shape[0]
        flat = fpn[-1].reshape(1, self._n_feat, c.d_model).expand(b, -1, -1)
        pos = self._feat_pos.expand(b, -1, -1)
        n_ptr_tokens = (c.max_obj_ptrs_in_encoder
                        * (c.hidden_dim // c.mem_dim))
        fused = self.model.memory_conditioned_features(
            flat, pos, memory, memory_pos, n_ptr_tokens, memory_valid)
        pix = fused.reshape(b, self._feat_hw, self._feat_hw, c.d_model)
        return self.model.forward_sam_heads(
            pix, coords, labels, mask_in, self._high_res(fpn), multimask)

    def _assemble_memory(self, mem, pos, tpos_rows, valid, optrs, ptr_valid):
        """Flatten the fixed-layout memory stacks into the attention operands
        (the concatenation of reference sam2_base.py:563-713, padded and
        masked here).

        mem / pos [b, R, n_tok, mem_dim] float32; tpos_rows [b, R, mem_dim];
        valid [b, R] bool; optrs [b, P, ptr_dim]; ptr_valid [b, P] bool."""
        c = self.cfg
        b, mem_dim = mem.shape[0], c.mem_dim
        keep = valid[:, :, None, None]
        pos = (pos + tpos_rows[:, :, None, :]) * keep
        mem = mem * keep
        split = c.hidden_dim // mem_dim
        ptr_keep = ptr_valid.repeat_interleave(split, dim=1)
        ptr_tokens = optrs.reshape(b, -1, mem_dim) * ptr_keep[:, :, None]
        memory = torch.cat([mem.reshape(b, -1, mem_dim), ptr_tokens], dim=1)
        memory_pos = torch.cat(
            [pos.reshape(b, -1, mem_dim), torch.zeros_like(ptr_tokens)], dim=1)
        memory_valid = torch.cat(
            [valid.repeat_interleave(self._n_feat, dim=1), ptr_keep], dim=1)
        return memory, memory_pos, memory_valid

    def _memory_operands(self, state, frame_idx, obj_indices, reverse):
        """The assembled memory of the given objects on one frame."""
        built = [self._build_memory(state, frame_idx, idx, reverse)
                 for idx in obj_indices]
        mem, pos, tpos_idx, valid, ptrs, ptr_valid = zip(*built)
        tpos_rows = self._tpos[self._dev(tpos_idx, torch.long)]
        return self._assemble_memory(
            torch.stack([torch.stack(rows) for rows in mem]),
            torch.stack([torch.stack(rows) for rows in pos]),
            tpos_rows, self._dev(valid, torch.bool),
            torch.stack([torch.stack(rows) for rows in ptrs]),
            self._dev(ptr_valid, torch.bool))

    @torch.no_grad()
    def _track_core(self, fpn, memory, memory_pos, memory_valid, multimask,
                    fill_area):
        """Memory-conditioned heads -> non-overlap -> memory encoding -> hole
        filling: one tracked frame on the device."""
        c = self.cfg
        lr, hr, _, obj_ptr, _ = self._track_heads(
            fpn, memory, memory_pos, memory_valid, multimask)
        hr_for_mem = hr[:, 0]
        if c.non_overlap_masks_for_mem_enc and hr_for_mem.shape[0] > 1:
            hr_for_mem = apply_non_overlapping_constraints(hr_for_mem)
        mem_feat, mem_pos = self._encode(fpn, hr_for_mem, is_pts=False)
        filled = fill_holes_in_mask_scores(lr[:, 0], fill_area)
        return lr, obj_ptr.float(), mem_feat, mem_pos, filled

    @torch.no_grad()
    def _consolidate_encode(self, fpn, lr_stack, nonoverlap):
        """Memory encoding of a prompted frame's consolidated object masks
        (reference _consolidate_temp_output_across_obj with
        run_mem_encoder=True): low-res masks -> image resolution ->
        optional non-overlap -> the memory encoder with
        is_mask_from_pts=True."""
        c = self.cfg
        hr = resize_hw(lr_stack, (c.image_size, c.image_size),
                       mode="bilinear")
        if nonoverlap:
            hr = apply_non_overlapping_constraints(hr)
        return self._encode(fpn, hr, is_pts=True)

    @torch.no_grad()
    def _video_res(self, masks, hw, nonoverlap):
        """Low-res mask logits [..., B, h, w] (a frame, or a scanned chunk
        of frames) -> the original video resolution (reference
        _get_orig_video_res_output: bilinear, align_corners False, +
        optional cross-object non-overlap)."""
        up = resize_hw(masks.float(), hw)
        return apply_non_overlapping_constraints(up) if nonoverlap else up

    @torch.no_grad()
    def _encode(self, fpn, high_res_masks, is_pts):
        """-> (memory features, position encoding), each [b, n_tok, mem_dim]
        float32, the form every memory slot is stored in."""
        b = high_res_masks.shape[0]
        mem, pos = self.model.encode_memory(
            fpn[-1], high_res_masks[..., None], is_pts)
        shape = (b, self._n_feat, self.cfg.mem_dim)
        return mem.reshape(shape).float(), pos.reshape(shape).float()

    @torch.no_grad()
    def _mask_as_output(self, fpn, mask_inputs):
        """use_mask_input_as_output_without_sam (sam2_base.py:457-507)."""
        c = self.cfg
        out_scale, out_bias = 20.0, -10.0
        hr = mask_inputs.float() * out_scale + out_bias
        lr = resize_hw(hr, (c.image_size // 4, c.image_size // 4),
                       mode="bilinear", antialias=True)
        # the object pointer comes from the SAM decoder on the downsampled
        # mask prompt
        b = mask_inputs.shape[0]
        mask_ds = self.model.downsample_mask(hr[..., None])
        heads = self.model.forward_sam_heads(
            fpn[-1], None, None, mask_ds, self._high_res(fpn), False)
        obj_ptr = heads[3]
        lam = (mask_inputs.reshape(b, -1) > 0).any(dim=1)[:, None].float()
        obj_score_logits = out_scale * lam + out_bias
        if c.pred_obj_scores and c.fixed_no_obj_ptr:
            obj_ptr = lam * obj_ptr + (1 - lam) * self.model.no_obj_ptr
        return lr, hr, obj_ptr, obj_score_logits

    # ------------------------------------------------------------- host API
    def init_state(self, images, store_on_device=True, video_height=None,
                   video_width=None):
        """images [T, S, S, 3] float in [0, 1], already resized to the
        square cfg.image_size. With store_on_device (default) the whole
        clip goes to the device once. video_height / video_width: the
        original video resolution, used by get_orig_video_res_output and
        propagate_in_video(output_video_res=True); defaults to the model's
        input size."""
        images = np.asarray(images, np.float32)
        assert images.shape[1] == images.shape[2] == self.cfg.image_size
        state = {
            "images": self._dev(images) if store_on_device else images,
            "num_frames": len(images),
            "video_height": int(video_height or self.cfg.image_size),
            "video_width": int(video_width or self.cfg.image_size),
            "point_inputs_per_obj": {},
            "mask_inputs_per_obj": {},
            "obj_id_to_idx": OrderedDict(),
            # obj_idx -> {"cond": {t: out}, "non_cond": {t: out}}
            "output_dict_per_obj": {},
            "feat_cache": {},
            # frame -> {"reverse": bool}; tells initial conditioning prompts
            # from correction clicks (reference :256-262)
            "frames_already_tracked": {},
            "tracking_has_started": False,
            # prompted frames whose decode outputs still need the preflight
            # memory encoding; frame -> is_cond
            "dirty_prompt_frames": {},
            # prompted frames already consolidated, by storage key
            "consolidated_frame_inds": {"cond": set(), "non_cond": set()},
        }
        self._get_features(state, 0)     # warm frame 0 as the reference does
        return state

    def _get_features(self, state, frame_idx):
        if frame_idx not in state["feat_cache"]:
            state["feat_cache"] = {
                frame_idx: self._features(self._dev(state["images"][frame_idx]))}
        return state["feat_cache"][frame_idx]

    def _obj_idx(self, state, obj_id):
        if obj_id not in state["obj_id_to_idx"]:
            if state["tracking_has_started"]:
                raise RuntimeError(
                    f"Cannot add new object id {obj_id} after tracking "
                    "starts; call reset_state to restart from scratch.")
            idx = len(state["obj_id_to_idx"])
            state["obj_id_to_idx"][obj_id] = idx
            state["point_inputs_per_obj"][idx] = {}
            state["mask_inputs_per_obj"][idx] = {}
            state["output_dict_per_obj"][idx] = {"cond": {}, "non_cond": {}}
        return state["obj_id_to_idx"][obj_id]

    def add_new_points_or_box(self, state, frame_idx, obj_id, points=None,
                              labels=None, box=None, normalize_coords=True,
                              clear_old_points=True):
        """Reference :171-318. Points are (x, y) in pixels of the model's
        input. `normalize_coords` is taken and ignored, as the JAX package
        does: points stay in the model input's pixels also when init_state
        was given video_height / video_width (the reference scales them from
        video pixels; ROADMAP C.15). clear_old_points=False appends the new
        clicks to the frame's prompts. On a frame that was tracked already
        the clicks correct the tracked mask (a memory-conditioned decode
        seeded with the previous logits) instead of starting a conditioning
        frame. Returns (frame_idx, object ids, low-res mask logits
        [n, h, w] on the device)."""
        idx = self._obj_idx(state, obj_id)
        if (points is not None) != (labels is not None):
            raise ValueError("points and labels must be provided together")
        if points is None and box is None:
            raise ValueError(
                "at least one of points or box must be provided as input")
        pts = np.zeros((0, 2), np.float32)
        lbl = np.zeros((0,), np.int64)
        if box is not None:
            if not clear_old_points:
                raise ValueError(
                    "cannot add box without clearing old points (box must "
                    "precede point prompts; use clear_old_points=True)")
            if state["tracking_has_started"]:
                warnings.warn(
                    "You are adding a box after tracking starts. SAM 2 may "
                    "not always be able to incorporate a box prompt for "
                    "*refinement*; for an *initial* box input, reset_state "
                    "first.", category=UserWarning, stacklevel=2)
            box = np.asarray(box, np.float32).reshape(2, 2)
            pts = np.concatenate([pts, box], axis=0)
            lbl = np.concatenate([lbl, np.array([2, 3], np.int64)])
        if points is not None:
            pts = np.concatenate([pts, np.asarray(points, np.float32)], axis=0)
            lbl = np.concatenate([lbl, np.asarray(labels, np.int64)])
        old = state["point_inputs_per_obj"][idx].get(frame_idx)
        if not clear_old_points and old is not None:
            pts = np.concatenate([old[0], pts], axis=0)
            lbl = np.concatenate([old[1], lbl], axis=0)
        state["point_inputs_per_obj"][idx][frame_idx] = (pts, lbl)
        state["mask_inputs_per_obj"][idx].pop(frame_idx, None)
        return self._interactive_predict(state, frame_idx, idx)

    def add_new_points(self, *args, **kwargs):
        """Deprecated alias (reference :314-317)."""
        return self.add_new_points_or_box(*args, **kwargs)

    def add_new_mask(self, state, frame_idx, obj_id, mask):
        """Reference :319-399; mask [S, S] binary at the model's input
        size."""
        idx = self._obj_idx(state, obj_id)
        state["mask_inputs_per_obj"][idx][frame_idx] = \
            np.asarray(mask, np.float32)
        state["point_inputs_per_obj"][idx].pop(frame_idx, None)
        return self._interactive_predict(state, frame_idx, idx)

    def _interactive_predict(self, state, frame_idx, target_idx):
        """Decode the newly prompted object on this frame and return it with
        the other prompted objects' stored outputs (the reference decodes
        only the clicked object, :252-301)."""
        fpn = self._get_features(state, frame_idx)
        obj_ids, masks = [], []
        for obj_id, idx in state["obj_id_to_idx"].items():
            if idx == target_idx:
                out = self._decode_prompt_frame(state, frame_idx, idx, fpn)
            elif (state["point_inputs_per_obj"][idx].get(frame_idx) is None
                  and state["mask_inputs_per_obj"][idx].get(frame_idx)
                  is None):
                out = None
            else:
                outs = state["output_dict_per_obj"][idx]
                out = outs["cond"].get(frame_idx,
                                       outs["non_cond"].get(frame_idx))
            if out is None:
                continue
            obj_ids.append(obj_id)
            masks.append(out["pred_masks"])
        hw = self.cfg.image_size // 4
        return frame_idx, obj_ids, (torch.cat(masks) if masks else
                                    torch.zeros((0, hw, hw),
                                                device=self.device))

    def _decode_prompt_frame(self, state, frame_idx, idx, fpn):
        """Decode one object's prompts on a frame (reference
        add_new_points_or_box / _run_single_frame_inference, :252-301). An
        initial conditioning frame runs without memory; a frame that was
        tracked already runs a memory-conditioned correction with the new
        clicks and the previous mask logits (clamped to +-32). The output is
        stored under "cond" or "non_cond" by
        add_all_frames_to_correct_as_cond; its memory encoding waits for
        the preflight consolidation, so that the cross-object non-overlap
        applies before it, as in the reference."""
        c = self.cfg
        pts = state["point_inputs_per_obj"][idx].get(frame_idx)
        msk = state["mask_inputs_per_obj"][idx].get(frame_idx)
        if pts is None and msk is None:
            return None
        is_init = frame_idx not in state["frames_already_tracked"]
        is_cond = is_init or c.add_all_frames_to_correct_as_cond
        if msk is not None and c.use_mask_input_as_output_without_sam:
            lr, hr, obj_ptr, _ = self._mask_as_output(
                fpn, self._dev(msk)[None])
            lr, hr = lr[:, None], hr[:, None]
        else:
            coords = labels = mask_in = None
            n_pts = 0
            if pts is not None:
                coords = self._dev(pts[0])[None]
                labels = self._dev(pts[1], torch.long)[None]
                n_pts = pts[0].shape[0]
            else:
                emb4 = c.sam_image_embedding_size * 4
                mask_in = resize_hw(self._dev(msk)[None], (emb4, emb4),
                                    mode="bilinear", antialias=True)[..., None]
            multimask = (c.multimask_output_in_sam
                         and (is_init or c.multimask_output_for_tracking)
                         and c.multimask_min_pt_num <= n_pts
                         <= c.multimask_max_pt_num)
            if is_init:
                lr, hr, _, obj_ptr, _ = self._cond(fpn, coords, labels,
                                                   mask_in, multimask)
            else:
                # correction: memory from the tracked neighbourhood, the
                # previous logits as the dense prompt (reference :268-285)
                reverse = state["frames_already_tracked"][frame_idx]["reverse"]
                outs = state["output_dict_per_obj"][idx]
                prev = outs["cond"].get(frame_idx,
                                        outs["non_cond"].get(frame_idx))
                if prev is not None and mask_in is None:
                    side = c.image_size // 4
                    prev_lr = prev["pred_masks"].reshape(1, side, side)
                    mask_in = torch.clamp(prev_lr, -32.0, 32.0)[..., None]
                memory = self._memory_operands(state, frame_idx, [idx],
                                               reverse)
                lr, hr, _, obj_ptr, _ = self._track_heads(
                    fpn, *memory, multimask, coords, labels, mask_in)
        out = {"pred_masks": lr[:, 0],
               "pred_masks_high_res": hr[:, 0],
               "obj_ptr": obj_ptr[0].float()}
        storage = "cond" if is_cond else "non_cond"
        state["output_dict_per_obj"][idx][storage][frame_idx] = out
        if is_cond:
            state["output_dict_per_obj"][idx]["non_cond"].pop(frame_idx, None)
        state["dirty_prompt_frames"][frame_idx] = is_cond
        return out

    # -------------------------------------------------------------- tracking
    @property
    def _track_multimask(self):
        c = self.cfg
        return bool(c.multimask_output_in_sam
                    and c.multimask_output_for_tracking
                    and c.multimask_min_pt_num <= 0 <= c.multimask_max_pt_num)

    def _build_memory(self, state, frame_idx, idx, reverse=False):
        """The fixed-layout memory of one object (sam2_base.py:563-713):
        conditioning frames (t_pos 0), the previous num_maskmem - 1 frames
        and up to max_obj_ptrs past object pointers. Every slot stayed on
        the device where the encode step produced it; the host builds only
        the validity flags and the rows' temporal-position indices.
        Returns (mem rows, pos rows, tpos indices, valid, pointer rows,
        pointer valid)."""
        c = self.cfg
        outs = state["output_dict_per_obj"][idx]
        sel_cond, unsel_cond = select_closest_cond_frames(
            frame_idx, outs["cond"], c.max_cond_frames_in_attn)

        entries = [(0, out) for out in sel_cond.values()]
        r = c.memory_temporal_stride_for_eval
        for t_pos in range(1, c.num_maskmem):
            t_rel = c.num_maskmem - t_pos
            if t_rel == 1:
                prev_idx = frame_idx + t_rel if reverse else frame_idx - t_rel
            elif not reverse:
                prev_idx = ((frame_idx - 2) // r) * r - (t_rel - 2) * r
            else:
                prev_idx = -(-(frame_idx + 2) // r) * r + (t_rel - 2) * r
            out = outs["non_cond"].get(prev_idx, unsel_cond.get(prev_idx))
            entries.append((t_pos, out))

        n_rows = max(1, len(entries))
        zero = self._zero_tok
        mem_rows, pos_rows = [zero] * n_rows, [zero] * n_rows
        tpos_idx, valid = [0] * n_rows, [False] * n_rows
        for row, (t_pos, out) in enumerate(entries):
            if out is None or "maskmem_features" not in out:
                continue
            mem_rows[row] = out["maskmem_features"]
            pos_rows[row] = out["maskmem_pos_enc"]
            tpos_idx[row] = c.num_maskmem - t_pos - 1
            valid[row] = True

        n_ptr = c.max_obj_ptrs_in_encoder
        ptr_rows, ptr_valid = [self._zero_ptr] * n_ptr, [False] * n_ptr
        if c.use_obj_ptrs_in_encoder:
            pool = ({t: o for t, o in sel_cond.items()
                     if (t >= frame_idx if reverse else t <= frame_idx)}
                    if c.only_obj_ptrs_in_the_past_for_eval
                    else dict(sel_cond))
            ptrs = [o["obj_ptr"] for o in pool.values()]
            for t_diff in range(1, min(state["num_frames"], n_ptr)):
                t = frame_idx + t_diff if reverse else frame_idx - t_diff
                if t < 0 or t >= state["num_frames"]:
                    break
                out = outs["non_cond"].get(t, unsel_cond.get(t))
                if out is not None:
                    ptrs.append(out["obj_ptr"])
            for j, p in enumerate(ptrs[:n_ptr]):
                ptr_rows[j], ptr_valid[j] = p, True
        return mem_rows, pos_rows, tpos_idx, valid, ptr_rows, ptr_valid

    def _track_frame(self, state, frame_idx, reverse=False):
        c = self.cfg
        fpn = self._get_features(state, frame_idx)
        n_obj = len(state["obj_id_to_idx"])
        memory = self._memory_operands(state, frame_idx, range(n_obj), reverse)
        lr, obj_ptr, mem_feat, mem_pos, filled = self._track_core(
            fpn, *memory, self._track_multimask, c.fill_hole_area)
        for idx in range(n_obj):
            nc = state["output_dict_per_obj"][idx]["non_cond"]
            nc[frame_idx] = {
                "pred_masks": lr[idx],
                "obj_ptr": obj_ptr[idx],
                "maskmem_features": mem_feat[idx],
                "maskmem_pos_enc": mem_pos[idx],
            }
            if self.history_window:
                # drop memories no later frame can select (symmetric in
                # distance, so reverse passes stay right)
                for t in [t for t in nc
                          if abs(t - frame_idx) > self.history_window]:
                    del nc[t]
        return filled

    # --------------------------------------------------------- chunked scan
    def _scan_key(self, n_obj, nc, ncp, reverse, num_frames):
        """What fixes the scan step's shapes and branches: objects,
        conditioning rows and pointers, direction, the multimask and hole
        filling branches, the pointer candidates (num_frames, up to
        max_obj_ptrs), the chunk, and whether the kernels are on."""
        c = self.cfg
        n_cand = max(min(num_frames, c.max_obj_ptrs_in_encoder) - 1, 0)
        return (n_obj, nc, ncp, bool(reverse), self._track_multimask,
                c.fill_hole_area, n_cand, self.scan_chunk, fusion_disabled())

    def _scan_buffers(self, key):
        """The static tensors of one key's step: the frame and its id, the
        run's constants (conditioning rows and pointers, the temporal
        position table), the rings, and the chunk's stacked outputs."""
        n_obj, nc, ncp, _, _, _, n_cand, ch, _ = key
        c = self.cfg
        n_tok, mem_dim, hid = self._n_feat, c.mem_dim, c.hidden_dim
        side, s = c.image_size // 4, c.image_size
        w, pw = self._ring_W, max(c.max_obj_ptrs_in_encoder, 1)

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        i64, b8 = torch.long, torch.bool
        return SimpleNamespace(
            frame=z(1, s, s, 3), t=z(1, dtype=i64), slot=z(1, dtype=i64),
            num_frames=z(1, dtype=i64),
            offs=torch.arange(1, n_cand + 1, device=self.device),
            cond_mem=z(n_obj, nc, n_tok, mem_dim),
            cond_pos=z(n_obj, nc, n_tok, mem_dim),
            cond_valid=z(n_obj, nc, dtype=b8),
            cond_ptrs=z(n_obj, ncp, hid),
            cond_ptr_valid=z(n_obj, ncp, dtype=b8),
            tpos=z(nc + c.num_maskmem - 1, mem_dim),
            ring_mem=z(n_obj, w, n_tok, mem_dim),
            ring_pos=z(n_obj, w, n_tok, mem_dim), ring_frame=z(w, dtype=i64),
            ptr_ring=z(n_obj, pw, hid), ptr_frame=z(pw, dtype=i64),
            outs=(z(ch, n_obj, 1, side, side), z(ch, n_obj, hid),
                  z(ch, n_obj, n_tok, mem_dim), z(ch, n_obj, n_tok, mem_dim),
                  z(ch, n_obj, side, side)))

    @torch.no_grad()
    def _scan_step(self, s, reverse, multimask, fill_area):
        """One tracked frame of a scanned run: the body of the JAX package's
        `_scan_impl` (`real_step`) on the static tensors `s` of its key.
        Reads the frame `s.frame` of id `s.t`, the run's constants and the
        rings; writes the frame's outputs at chunk row `s.slot` and its
        memory and pointer into the rings, and moves `s.t` and `s.slot` on
        by one frame. Plain tensor code without a host synchronisation, so
        that a CUDA graph can replay it.

        The memory rows are the conditioning rows, then the strided previous
        frames (reference sam2_base.py:563-713) looked up in the ring by
        frame id modulo its size; a row is valid where its slot holds that
        very frame. The pointer rows are the conditioning pointers, then the
        tracked frames' pointers nearest first: the k-th valid candidate
        lands in row ncp + k - 1, the rest in a dump row that is cut off."""
        c = self.cfg
        m, r = c.num_maskmem, max(c.memory_temporal_stride_for_eval, 1)
        b, w = s.ring_mem.shape[:2]
        pw, ncp = s.ptr_ring.shape[1], s.cond_ptrs.shape[1]
        total_ptr = c.max_obj_ptrs_in_encoder
        t = s.t
        fpn = self._features(s.frame[0])

        # frame ids below 0 at a run's start: // and % on tensors floor and
        # take the divisor's sign, as jnp's do
        prevs = []
        for t_pos in range(1, m):
            t_rel = m - t_pos
            if t_rel == 1:
                prevs.append(t + 1 if reverse else t - 1)
            elif reverse:
                prevs.append(-(-(t + 2) // r) * r + (t_rel - 2) * r)
            else:
                prevs.append(((t - 2) // r) * r - (t_rel - 2) * r)
        prevs = torch.cat(prevs)
        slots = prevs % w
        mem = torch.cat([s.cond_mem, s.ring_mem.index_select(1, slots)], 1)
        pos = torch.cat([s.cond_pos, s.ring_pos.index_select(1, slots)], 1)
        ok = ((s.ring_frame.index_select(0, slots) == prevs) & (prevs >= 0)
              & (prevs < s.num_frames))
        valid = torch.cat([s.cond_valid, ok[None].expand(b, -1)], 1)

        fs = t + s.offs if reverse else t - s.offs
        pslots = fs % pw
        pok = ((s.ptr_frame.index_select(0, pslots) == fs) & (fs >= 0)
               & (fs < s.num_frames))
        if not c.use_obj_ptrs_in_encoder:
            pok = torch.zeros_like(pok)
        rank = torch.cumsum(pok.long(), 0)
        row = torch.where(pok & (rank <= total_ptr - ncp), ncp + rank - 1,
                          total_ptr)
        optrs = torch.cat([s.cond_ptrs, s.cond_ptrs.new_zeros(
            b, total_ptr + 1 - ncp, s.cond_ptrs.shape[2])], 1)
        optrs.index_copy_(1, row, s.ptr_ring.index_select(1, pslots))
        taken = torch.zeros(total_ptr + 1, dtype=torch.bool,
                            device=t.device).index_fill_(0, row, True)
        ptr_valid = torch.cat([s.cond_ptr_valid, s.cond_ptr_valid.new_zeros(
            b, total_ptr - ncp)], 1) | taken[None, :total_ptr]

        memory = self._assemble_memory(mem, pos, s.tpos[None], valid,
                                       optrs[:, :total_ptr], ptr_valid)
        outs = self._track_core(fpn, *memory, multimask, fill_area)
        lr, obj_ptr, mem_feat, mem_pos, _ = outs
        s.ring_mem.index_copy_(1, t % w, mem_feat[:, None])
        s.ring_pos.index_copy_(1, t % w, mem_pos[:, None])
        s.ring_frame.index_copy_(0, t % w, t)
        s.ptr_ring.index_copy_(1, t % pw, obj_ptr[:, None])
        s.ptr_frame.index_copy_(0, t % pw, t)
        for out, x in zip(s.outs, outs):
            out.index_copy_(0, s.slot, x[None])
        t.add_(-1 if reverse else 1)
        s.slot.copy_((s.slot + 1) % s.outs[0].shape[0])

    def _fill_scan_buffers(self, s, state, conds, pools, start, reverse):
        """Fill the static tensors in place for a run that starts at frame
        `start`: the conditioning rows and pointers (run constants: a run
        never straddles a conditioning frame, and every step sees all of
        them, as max_cond_frames_in_attn does not bind), the temporal
        position table, and the rings seeded from the frames already tracked
        in the lookback (a propagation restarted mid-video)."""
        c = self.cfg
        n_obj, nc = s.cond_valid.shape
        n_tok, mem_dim, m = self._n_feat, c.mem_dim, c.num_maskmem
        w, pw = s.ring_frame.shape[0], s.ptr_frame.shape[0]

        def tok(x):
            return x.reshape(n_tok, mem_dim).float()

        s.cond_mem.zero_()
        s.cond_pos.zero_()
        cond_valid = np.zeros((n_obj, nc), bool)
        for o, cd in enumerate(conds):
            for k, out in enumerate(cd.values()):
                if "maskmem_features" in out:
                    s.cond_mem[o, k].copy_(tok(out["maskmem_features"]))
                    s.cond_pos[o, k].copy_(tok(out["maskmem_pos_enc"]))
                    cond_valid[o, k] = True
        s.cond_valid.copy_(torch.from_numpy(cond_valid))
        s.cond_ptrs.zero_()
        ptr_valid = np.zeros(tuple(s.cond_ptr_valid.shape), bool)
        for o, pool in enumerate(pools):
            for k, p in enumerate(pool):
                s.cond_ptrs[o, k].copy_(p.float())
                ptr_valid[o, k] = True
        s.cond_ptr_valid.copy_(torch.from_numpy(ptr_valid))
        # conditioning rows take t_pos 0, then t_pos 1 .. num_maskmem - 1 (the
        # rows of `_build_memory`)
        s.tpos.copy_(self._tpos[self._dev(
            [m - 1] * nc + [m - t_pos - 1 for t_pos in range(1, m)],
            torch.long)])

        def seed(ring_frame, rings, size, key, rows):
            frame_ids = np.full((size,), -1, np.int64)
            for ring in rings:
                ring.zero_()
            seeds = (range(start + 1, start + size + 1) if reverse
                     else range(max(start - size, 0), start))
            for f in seeds:
                outs = [state["output_dict_per_obj"][o]["non_cond"].get(f)
                        for o in range(n_obj)]
                if all(o is not None and key in o for o in outs):
                    frame_ids[f % size] = f
                    for o in range(n_obj):
                        for ring, value in zip(rings, rows(outs[o])):
                            ring[o, f % size].copy_(value)
            ring_frame.copy_(torch.from_numpy(frame_ids))

        seed(s.ring_frame, (s.ring_mem, s.ring_pos), w, "maskmem_features",
             lambda out: (tok(out["maskmem_features"]),
                          tok(out["maskmem_pos_enc"])))
        seed(s.ptr_frame, (s.ptr_ring,), pw, "obj_ptr",
             lambda out: (out["obj_ptr"].float(),))
        s.t.fill_(start)
        s.slot.zero_()
        s.num_frames.fill_(state["num_frames"])

    def _scan_entry(self, key):
        """The key's step (buffers, and its CUDA graph once captured), most
        recently used last; the least recently used beyond _SCAN_GRAPHS is
        dropped with its graph and pool."""
        steps = self._scan_steps
        if key in steps:
            steps.move_to_end(key)
        else:
            steps[key] = SimpleNamespace(bufs=self._scan_buffers(key),
                                         graph=None, held=(), owner=None)
            while len(steps) > _SCAN_GRAPHS:
                steps.popitem(last=False)
        return steps[key]

    def _capture_scan_step(self, entry, key, args):
        """Capture the key's step in a CUDA graph. First one eager step on a
        copy of the buffers, on the stream that captures, does the work of
        a first use (the kernels' build and attributes, the cached tables,
        the library handles) without writing a live ring; the tables the
        step reads stay held beside the graph. Raises if the capture fails:
        a scanned run is never tracked eagerly on the card."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            scratch = SimpleNamespace(**{
                k: (tuple(x.clone() for x in v) if k == "outs" else v.clone())
                for k, v in vars(entry.bufs).items()})
            self._scan_step(scratch, *args)
        torch.cuda.current_stream(dev).wait_stream(side)
        del scratch
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with holding() as held, torch.cuda.graph(graph, stream=side):
            self._scan_step(entry.bufs, *args)
        torch.cuda.synchronize(dev)
        entry.graph, entry.held = graph, held
        stats = self.scan_stats
        stats["captures"][key] = stats["captures"].get(key, 0) + 1
        stats["capture_s"][key] = time.perf_counter() - t0
        stats["pool_bytes"][key] = torch.cuda.memory_reserved(dev) - reserved

    def _scan_chunk(self, entry, images, n, args):
        """Track the next `n` frames of a run: a frame copy and a graph
        replay each (the step itself on the CPU); returns copies of the
        chunk's outputs (lr, obj_ptr, mem_feat, mem_pos, filled), [n, ...]
        each."""
        s = entry.bufs
        for _ in range(n):
            torch.index_select(images, 0, s.t, out=s.frame)
            if entry.graph is None:
                self._scan_step(s, *args)
            else:
                entry.graph.replay()
                self.scan_stats["replays"] += 1
        return tuple(o[:n].clone() for o in s.outs)

    def _scan_plan(self, state, run, reverse, video_res=False):
        """A generator that tracks `run` (consecutive non-prompted frames in
        propagation order) by the chunked scan, or None where the JAX
        package takes the per-frame path: scanning off, a one-frame run, no
        object, no memory, history_window 0 (every per-frame entry kept),
        the clip on the host, or more conditioning frames than
        max_cond_frames_in_attn (the per-frame path then picks the closest
        ones per frame, `_build_memory`).

        The generator dispatches chunk k + 1 before it yields chunk k, keeps
        the last chunks that the history window can reach, and writes their
        frames back as per-frame entries (`_scan_writeback`) before the last
        chunk's yields, or when the consumer abandons it."""
        c = self.cfg
        ch = self.scan_chunk
        n_obj = len(state["obj_id_to_idx"])
        if (not ch or ch < 2 or len(run) < 2 or n_obj == 0
                or c.num_maskmem < 2 or not self.history_window
                or isinstance(state["images"], np.ndarray)):
            return None
        conds = [state["output_dict_per_obj"][o]["cond"]
                 for o in range(n_obj)]
        if (c.max_cond_frames_in_attn != -1
                and any(len(cd) > c.max_cond_frames_in_attn for cd in conds)):
            return None
        start = run[0]
        # conditioning pointers: the reference's pool, cond pointers first,
        # those in the past only for eval
        pools = []
        for cd in conds:
            pool = []
            if c.use_obj_ptrs_in_encoder:
                pool = [out["obj_ptr"] for t0, out in cd.items()
                        if not c.only_obj_ptrs_in_the_past_for_eval
                        or (t0 >= start if reverse else t0 <= start)]
            pools.append(pool[:c.max_obj_ptrs_in_encoder])
        nc = max(len(cd) for cd in conds)
        ncp = max(len(p) for p in pools)
        key = self._scan_key(n_obj, nc, ncp, reverse, state["num_frames"])
        args = (reverse, self._track_multimask, c.fill_hole_area)
        keep = -(-self.history_window // ch) + 1
        hw = (state["video_height"], state["video_width"])

        def gen():
            entry = self._scan_entry(key)
            token = entry.owner = object()
            self._fill_scan_buffers(entry.bufs, state, conds, pools, start,
                                    reverse)
            if self.device.type == "cuda" and entry.graph is None:
                self._capture_scan_step(entry, key, args)
            recent, pend, wrote_back = [], None, False
            try:
                for k in range(0, len(run), ch):
                    if entry.owner is not token:
                        raise RuntimeError(
                            "another scanned run took this run's buffers; "
                            "drain one propagate_in_video before starting "
                            "another with the same objects and prompts")
                    chunk = run[k:k + ch]
                    outs = self._scan_chunk(entry, state["images"],
                                            len(chunk), args)
                    recent.append((chunk, outs))
                    del recent[:-keep]
                    if pend is not None:
                        yield from zip(*pend)
                    filled = outs[4]
                    if video_res:
                        filled = self._video_res(filled, hw,
                                                 self.non_overlap_masks)
                    pend = (chunk, filled)
                self._scan_writeback(state, recent)
                wrote_back = True
                if pend is not None:
                    yield from zip(*pend)
            finally:
                # a consumer that abandons the run still leaves entries for
                # the frames tracked so far, for a later correction click or
                # a resumed propagation
                if not wrote_back:
                    self._scan_writeback(state, recent)
        return gen()

    def _scan_writeback(self, state, recent):
        """Per-frame non_cond entries (views of the chunks' outputs) for the
        frames of a scanned run within history_window of its last frame,
        and older ones dropped: the bound the per-frame path keeps."""
        if not recent:
            return
        n_obj = len(state["obj_id_to_idx"])
        last = recent[-1][0][-1]
        w = self.history_window
        for chunk, (lr, obj_ptr, mem_feat, mem_pos, _) in recent:
            for i, t in enumerate(chunk):
                if abs(t - last) > w:
                    continue
                for o in range(n_obj):
                    state["output_dict_per_obj"][o]["non_cond"][t] = {
                        "pred_masks": lr[i, o],
                        "obj_ptr": obj_ptr[i, o],
                        "maskmem_features": mem_feat[i, o],
                        "maskmem_pos_enc": mem_pos[i, o],
                    }
        for o in range(n_obj):
            nc = state["output_dict_per_obj"][o]["non_cond"]
            for t in [t for t in nc if abs(t - last) > w]:
                del nc[t]

    def _propagate_run(self, state, run, reverse, video_res=False):
        """Track one maximal run of consecutive non-prompted frames,
        yielding (frame_idx, filled mask logits [b, H, W]): low-res, or at
        the original video resolution with video_res."""
        scan = self._scan_plan(state, run, reverse, video_res)
        if scan is not None:
            yield from scan
            return
        for t in run:
            m = self._track_frame(state, t, reverse)
            if video_res:
                m = self.get_orig_video_res_output(state, m)[1]
            yield t, m

    def _empty_mask_ptr(self, fpn):
        """A dummy object pointer from an empty mask on this frame
        (reference _get_empty_mask_ptr, :542-577), for objects that have
        neither an input nor a tracked output on a prompted frame."""
        c = self.cfg
        s = c.image_size
        if c.use_mask_input_as_output_without_sam:
            ptr = self._mask_as_output(
                fpn, torch.zeros((1, s, s), device=self.device))[2]
        else:
            emb4 = c.sam_image_embedding_size * 4
            mask_in = torch.zeros((1, emb4, emb4, 1), device=self.device)
            ptr = self._cond(fpn, None, None, mask_in, False)[3]
        return ptr[0].float()

    def _clear_non_cond_mem_around_input(self, state, frame_idx):
        """Drop the non-conditioning memories within the maskmem lookback of
        a prompted frame (reference :954-975), so that correction clicks
        are not diluted by outdated memories around them. The prompted
        frame's own entry is kept: it may be the correction just
        consolidated."""
        c = self.cfg
        r = c.memory_temporal_stride_for_eval
        lo, hi = frame_idx - r * c.num_maskmem, frame_idx + r * c.num_maskmem
        for idx in range(len(state["obj_id_to_idx"])):
            nc = state["output_dict_per_obj"][idx]["non_cond"]
            for t in [t for t in nc if lo <= t <= hi and t != frame_idx]:
                del nc[t]

    def _should_clear_non_cond(self, state):
        return (self.clear_non_cond_mem_around_input
                and (self.clear_non_cond_mem_for_multi_obj
                     or len(state["obj_id_to_idx"]) <= 1))

    def propagate_in_video_preflight(self, state):
        """Consolidate newly prompted frames before tracking (reference
        :579-646): on every dirty prompted frame, objects without an output
        get a NO_OBJ_SCORE mask and an empty-mask pointer, then the memory
        encoder runs over all objects' masks in one batch (with the
        cross-object non-overlap if configured)."""
        state["tracking_has_started"] = True
        c = self.cfg
        n_obj = len(state["obj_id_to_idx"])
        hw = c.image_size // 4
        dirty = state["dirty_prompt_frames"]
        for t in sorted(dirty):
            is_cond = dirty[t]
            storage = "cond" if is_cond else "non_cond"
            fpn = self._get_features(state, t)
            # every object with inputs on this frame is decoded (add_new_*
            # did that already; this covers a state changed by hand)
            for idx in range(n_obj):
                outs = state["output_dict_per_obj"][idx]
                if (t not in outs["cond"] and t not in outs["non_cond"]
                        and (t in state["point_inputs_per_obj"][idx]
                             or t in state["mask_inputs_per_obj"][idx])):
                    self._decode_prompt_frame(state, t, idx, fpn)
            empty_ptr = None
            lrs = []
            for idx in range(n_obj):
                outs = state["output_dict_per_obj"][idx]
                out = outs[storage].get(
                    t, outs["cond"].get(t, outs["non_cond"].get(t)))
                if out is None:
                    if empty_ptr is None:
                        empty_ptr = self._empty_mask_ptr(fpn)
                    out = {"pred_masks": torch.full(
                               (1, hw, hw), NO_OBJ_SCORE, device=self.device),
                           "obj_ptr": empty_ptr}
                if t not in outs[storage]:
                    # the consolidated frame is stored under one key for
                    # every object (reference :521-539), also for an object
                    # whose output so far sits under the other key
                    out = outs[storage][t] = dict(out)
                lrs.append(out["pred_masks"].reshape(1, hw, hw))
            if c.num_maskmem > 0 and n_obj > 0:
                nonoverlap = c.non_overlap_masks_for_mem_enc and n_obj > 1
                mem, pos = self._consolidate_encode(fpn, torch.cat(lrs),
                                                    nonoverlap)
                for idx in range(n_obj):
                    out = state["output_dict_per_obj"][idx][storage][t]
                    out["maskmem_features"] = mem[idx]
                    out["maskmem_pos_enc"] = pos[idx]
            state["consolidated_frame_inds"][storage].add(t)
            if is_cond:
                # an output promoted to cond evicts an earlier non-cond
                # output on the same frame (reference :626-632)
                state["consolidated_frame_inds"]["non_cond"].discard(t)
                for idx in range(n_obj):
                    state["output_dict_per_obj"][idx]["non_cond"].pop(t, None)
            if self._should_clear_non_cond(state):
                self._clear_non_cond_mem_around_input(state, t)
        dirty.clear()

    def reset_state(self, state):
        """Remove all prompts, objects and tracking results (reference
        :770-801); the frames and the feature cache stay."""
        state["obj_id_to_idx"].clear()
        state["point_inputs_per_obj"].clear()
        state["mask_inputs_per_obj"].clear()
        state["output_dict_per_obj"].clear()
        state["frames_already_tracked"].clear()
        state["dirty_prompt_frames"].clear()
        state["consolidated_frame_inds"]["cond"].clear()
        state["consolidated_frame_inds"]["non_cond"].clear()
        state["tracking_has_started"] = False

    def get_orig_video_res_output(self, state, masks):
        """(low-res masks, masks at the original video resolution) --
        reference _get_orig_video_res_output (:402-422). masks [B, h, w]
        logits; both results are device tensors."""
        masks = self._dev(masks)
        hw = (state["video_height"], state["video_width"])
        if tuple(masks.shape[-2:]) == hw and not self.non_overlap_masks:
            return masks, masks
        return masks, self._video_res(masks, hw, self.non_overlap_masks)

    def propagate_in_video(self, state, start_frame_idx=None,
                           max_frame_num_to_track=None, reverse=False,
                           output_video_res=False):
        """Generator over (frame_idx, obj_ids, mask logits [B, H, W] on the
        device): low-res (image_size / 4) by default, at the original video
        resolution (+ optional non-overlap) with output_video_res, which is
        what the reference yields (:724-739). Prompted frames yield their
        consolidated outputs; each maximal run of the others goes through
        `_propagate_run` (the chunked scan where it may run)."""
        self.propagate_in_video_preflight(state)
        obj_ids = list(state["obj_id_to_idx"].keys())
        cond_frames = set()
        for idx in range(len(obj_ids)):
            cond_frames |= set(state["output_dict_per_obj"][idx]["cond"])
        assert cond_frames, "no prompts provided"
        if start_frame_idx is None:
            start_frame_idx = min(cond_frames)
        if max_frame_num_to_track is None:
            max_frame_num_to_track = state["num_frames"]
        if reverse:
            end = max(start_frame_idx - max_frame_num_to_track, 0)
            rng = (range(start_frame_idx, end - 1, -1)
                   if start_frame_idx > 0 else [start_frame_idx])
        else:
            end = min(start_frame_idx + max_frame_num_to_track,
                      state["num_frames"] - 1)
            rng = range(start_frame_idx, end + 1)
        hw = self.cfg.image_size // 4
        inds = state["consolidated_frame_inds"]
        prompted = inds["cond"] | inds["non_cond"]
        ts = list(rng)
        i = 0
        while i < len(ts):
            t = ts[i]
            if t not in prompted:
                # a maximal run of non-prompted frames: the chunked scan
                # where it may run, else frame by frame (`_propagate_run`)
                j = i
                while j < len(ts) and ts[j] not in prompted:
                    j += 1
                for t2, masks in self._propagate_run(state, ts[i:j], reverse,
                                                     output_video_res):
                    state["frames_already_tracked"][t2] = {"reverse": reverse}
                    yield t2, obj_ids, masks
                i = j
                continue
            # prompted frames keep their consolidated outputs (reference
            # :695-705)
            rows = []
            for k in range(len(obj_ids)):
                outs = state["output_dict_per_obj"][k]
                out = outs["cond"].get(t, outs["non_cond"].get(t))
                rows.append(
                    out["pred_masks"].reshape(hw, hw) if out is not None
                    else torch.full((hw, hw), NO_OBJ_SCORE,
                                    device=self.device))
            masks = fill_holes_in_mask_scores(torch.stack(rows),
                                              self.cfg.fill_hole_area)
            if t in inds["cond"] and self._should_clear_non_cond(state):
                self._clear_non_cond_mem_around_input(state, t)
            state["frames_already_tracked"][t] = {"reverse": reverse}
            if output_video_res:
                masks = self.get_orig_video_res_output(state, masks)[1]
            yield t, obj_ids, masks
            i += 1
