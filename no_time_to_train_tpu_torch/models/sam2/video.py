"""SAM2 video predictor, per-frame tracking (port of
`no_time_to_train_tpu/models/sam2/video.py`; reference
sam2/sam2_video_predictor.py).

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
never waits for them. The JAX package's chunked-scan tracker is not ported:
every run takes the per-frame path.
"""
import warnings
from collections import OrderedDict

import numpy as np
import torch

from no_time_to_train_tpu_torch.models.matching.pipeline import (
    IMAGENET_MEAN, IMAGENET_STD)
from no_time_to_train_tpu_torch.models.sam2.model import NO_OBJ_SCORE
from no_time_to_train_tpu_torch.models.sam2.pos_enc import sine_pos_embed_2d
from no_time_to_train_tpu_torch.ops.connected_components import (
    fill_holes_in_mask_scores)
from no_time_to_train_tpu_torch.ops.resize import resize_hw

__all__ = ["SAM2VideoPredictor", "apply_non_overlapping_constraints",
           "select_closest_cond_frames"]


def apply_non_overlapping_constraints(pred_masks):
    """Keep only the highest-scoring object at each pixel and push the
    others to <= -10 (reference sam2_base.py:869-887). pred_masks
    [B, H, W]."""
    if pred_masks.shape[0] == 1:
        return pred_masks
    max_obj = torch.argmax(pred_masks, dim=0, keepdim=True)
    batch_obj = torch.arange(pred_masks.shape[0],
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
        """Low-res mask logits [B, h, w] -> the original video resolution
        (reference _get_orig_video_res_output: bilinear, align_corners
        False, + optional cross-object non-overlap)."""
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
                              labels=None, box=None, clear_old_points=True):
        """Reference :171-318. Points are (x, y) in pixels of the model's
        input. clear_old_points=False appends the new clicks to the frame's
        prompts. On a frame that was tracked already the clicks correct the
        tracked mask (a memory-conditioned decode seeded with the previous
        logits) instead of starting a conditioning frame. Returns
        (frame_idx, object ids, low-res mask logits [n, h, w] on the
        device)."""
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
        what the reference yields (:724-739)."""
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
        for t in rng:
            if t in prompted:
                # prompted frames keep their consolidated outputs
                # (reference :695-705)
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
            else:
                masks = self._track_frame(state, t, reverse)
            state["frames_already_tracked"][t] = {"reverse": reverse}
            if output_video_res:
                masks = self.get_orig_video_res_output(state, masks)[1]
            yield t, obj_ids, masks
