"""The video slice as a whole: the port's SAM2VideoPredictor against the JAX
predictor, both on the per-frame path (scan_chunk = 0; the chunked scan is
held in tests/test_torch_video_scan.py), on the CPU in float32, on the
tiny config of tests/test_video_scan.py, with the same numpy-seeded clip and
weights carried through `utils/convert.py`.

Tolerance: 2e-3 absolute and relative on the low-res mask logits. One frame
of the SAM heads agrees within 5e-4 (tests/test_torch_memory.py); a tracked
frame reads the memories and pointers of up to seven earlier frames, so the
two frameworks' float32 rounding differences are carried through the
recurrence of nine frames, twice (forward, then in reverse after a
correction).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.config.presets import Sam2Config
from no_time_to_train_tpu.models.matching.pipeline import _random_params_like
from no_time_to_train_tpu.models.sam2.model import SAM2 as JSAM2
from no_time_to_train_tpu.models.sam2 import video as jvideo
from no_time_to_train_tpu_torch.models.sam2.model import SAM2
from no_time_to_train_tpu_torch.models.sam2 import video as tvideo
from no_time_to_train_tpu_torch.utils.convert import sam2_state_dict
from no_time_to_train_tpu_torch.utils.init import init_random_

IMG, T = 128, 9
TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny model's thousands of small ops per frame on one intra-op
    thread: beside the other test processes on the same cores, a pool of 8
    threads to wake per op made these files 4-5 x slower (restored after
    the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg(**kw):
    return Sam2Config(
        embed_dim=32, num_heads=1, stages=(1, 1, 1, 1),
        global_att_blocks=(2,), window_pos_embed_bkg_spatial_size=(2, 2),
        window_spec=(4, 2, 4, 2), backbone_channel_list=(256, 128, 64, 32),
        image_size=IMG, **kw)


def _frames(n, seed=3):
    rng = np.random.default_rng(seed)
    frames = rng.random((n, IMG, IMG, 3)).astype(np.float32)
    for t in range(n):
        x0 = 10 + 3 * t
        frames[t, 40:90, x0:x0 + 40] = 0.9
        frames[t, 20:50, 80:115] = 0.1
    return frames


def _predictors(cfg, seed=0, **kw):
    jm = JSAM2(cfg)
    params = _random_params_like(
        lambda k: jm.init(k, jnp.zeros((1, IMG, IMG, 3)),
                          method=jm.init_everything),
        jax.random.PRNGKey(seed), seed)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)
    jp = jvideo.SAM2VideoPredictor(jm, params, **kw)
    jp.scan_chunk = 0
    tm = SAM2(cfg)
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in
                        sam2_state_dict(params).items()}, strict=True)
    tp = tvideo.SAM2VideoPredictor(tm, device="cpu", **kw)
    tp.scan_chunk = 0
    return jp, tp


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **TOL)


def _both(jp, tp, js, ts, method, *args, **kw):
    """One interactive call on both predictors; the returned masks agree."""
    jt, jids, jm = getattr(jp, method)(js, *args, **kw)
    tt, tids, tm = getattr(tp, method)(ts, *args, **kw)
    assert (jt, list(jids)) == (tt, list(tids))
    _close(tm, jm, f"{method}{args[:2]}")


def _propagate_both(jp, tp, js, ts, **kw):
    want = {t: (ids, np.asarray(m))
            for t, ids, m in jp.propagate_in_video(js, **kw)}
    got = {t: (ids, m.numpy()) for t, ids, m in
           tp.propagate_in_video(ts, **kw)}
    assert list(got) == list(want)
    for t in want:
        assert got[t][0] == want[t][0]
        _close(got[t][1], want[t][1], f"frame {t} {kw}")
    return got


def test_video_predictor_matches_jax_forward_reverse_correction():
    """Two objects prompted on frame 0, nine frames forward, a correction
    click (one positive, one negative) on tracked frame 4, then the whole
    clip in reverse from the last frame, at video resolution too."""
    cfg = _tiny_cfg(fill_hole_area=8)
    jp, tp = _predictors(cfg)
    frames = _frames(T)
    js = jp.init_state(frames, video_height=96, video_width=160)
    ts = tp.init_state(frames, video_height=96, video_width=160)
    pt = lambda *xy: np.array(xy, np.float32).reshape(-1, 2)
    one = np.array([1], np.int32)
    _both(jp, tp, js, ts, "add_new_points_or_box", 0, 1, points=pt(30, 60),
          labels=one)
    _both(jp, tp, js, ts, "add_new_points_or_box", 0, 2, points=pt(95, 30),
          labels=one)
    fwd = _propagate_both(jp, tp, js, ts)
    assert sorted(fwd) == list(range(T))
    assert all(m.shape == (2, IMG // 4, IMG // 4) for _, m in fwd.values())

    _both(jp, tp, js, ts, "add_new_points_or_box", 4, 1,
          points=pt(45, 60, 100, 30), labels=np.array([1, 0], np.int32))
    assert ts["dirty_prompt_frames"] == js["dirty_prompt_frames"] == {4: False}
    rev = _propagate_both(jp, tp, js, ts, start_frame_idx=T - 1, reverse=True)
    assert list(rev) == list(range(T - 1, -1, -1))
    for o in range(2):
        for key in ("cond", "non_cond"):
            assert (set(ts["output_dict_per_obj"][o][key])
                    == set(js["output_dict_per_obj"][o][key]))
    assert ts["frames_already_tracked"] == js["frames_already_tracked"]

    res = _propagate_both(jp, tp, js, ts, start_frame_idx=2,
                          max_frame_num_to_track=2, output_video_res=True)
    assert all(m.shape == (2, 96, 160) for _, m in res.values())


def test_video_predictor_matches_jax_mask_box_and_hygiene():
    """A mask prompt (use_mask_input_as_output_without_sam) for one object
    and a box for another that is prompted on a later frame only (the
    placeholder and empty-mask pointer of the preflight), a temporal stride
    of 2, the non-overlap constraints and the memory-clearing knobs; then a
    correction that appends a click to the box, and reset_state."""
    cfg = _tiny_cfg(fill_hole_area=0, memory_temporal_stride_for_eval=2,
                    non_overlap_masks_for_mem_enc=True)
    kw = dict(clear_non_cond_mem_around_input=True,
              clear_non_cond_mem_for_multi_obj=True, non_overlap_masks=True)
    jp, tp = _predictors(cfg, seed=1, **kw)
    frames = _frames(8, seed=5)
    js, ts = jp.init_state(frames), tp.init_state(frames)
    mask = np.zeros((IMG, IMG), np.float32)
    mask[40:90, 10:50] = 1.0
    _both(jp, tp, js, ts, "add_new_mask", 0, 1, mask)
    _both(jp, tp, js, ts, "add_new_points_or_box", 3, 2,
          box=[70.0, 15.0, 120.0, 55.0])
    fwd = _propagate_both(jp, tp, js, ts, output_video_res=True)
    assert sorted(fwd) == list(range(8))
    _both(jp, tp, js, ts, "add_new_points_or_box", 5, 2,
          points=np.array([[90.0, 30.0]], np.float32),
          labels=np.array([1], np.int32), clear_old_points=False)
    assert 5 in ts["output_dict_per_obj"][1]["non_cond"]
    _propagate_both(jp, tp, js, ts, start_frame_idx=7, reverse=True)
    with pytest.raises(RuntimeError):
        tp.add_new_points_or_box(ts, 0, 9, points=[[1.0, 1.0]], labels=[1])
    with pytest.raises(ValueError):
        tp.add_new_points_or_box(ts, 0, 1, points=[[1.0, 1.0]])
    tp.reset_state(ts)
    assert not ts["obj_id_to_idx"] and not ts["tracking_has_started"]


def test_correction_as_cond_frame_with_two_objects():
    """add_all_frames_to_correct_as_cond with a second object that was only
    tracked on the corrected frame: the consolidated frame is stored under
    "cond" for both objects (the JAX predictor raises KeyError here, so the
    port is held to the reference's semantics alone)."""
    cfg = _tiny_cfg(fill_hole_area=0, add_all_frames_to_correct_as_cond=True)
    tm = SAM2(cfg)
    init_random_(tm, torch.Generator().manual_seed(0))
    tp = tvideo.SAM2VideoPredictor(tm, device="cpu")
    ts = tp.init_state(_frames(5))
    one = np.array([1], np.int32)
    for obj, xy in ((1, [30.0, 60.0]), (2, [95.0, 30.0])):
        tp.add_new_points_or_box(ts, 0, obj, points=[xy], labels=one)
    first = {t: m for t, _, m in tp.propagate_in_video(ts)}
    tp.add_new_points_or_box(ts, 3, 2, points=[[90.0, 35.0]], labels=one)
    again = {t: m for t, _, m in tp.propagate_in_video(ts)}
    for o in range(2):
        outs = ts["output_dict_per_obj"][o]
        assert set(outs["cond"]) == {0, 3} and 3 not in outs["non_cond"]
        assert "maskmem_features" in outs["cond"][3]
    # object 1 keeps its tracked mask on the corrected frame
    torch.testing.assert_close(again[3][0], first[3][0])
    assert all(torch.isfinite(m).all() for m in again.values())


def test_correction_as_cond_frame_with_one_object_matches_jax():
    """add_all_frames_to_correct_as_cond with one object, where the JAX
    predictor runs: a correction click on tracked frame 3 turns it into a
    conditioning frame, and the clip tracked again agrees frame by frame."""
    cfg = _tiny_cfg(fill_hole_area=0, add_all_frames_to_correct_as_cond=True)
    jp, tp = _predictors(cfg, seed=2)
    frames = _frames(6)
    js, ts = jp.init_state(frames), tp.init_state(frames)
    one = np.array([1], np.int32)
    pt = np.array([[30.0, 60.0]], np.float32)
    _both(jp, tp, js, ts, "add_new_points_or_box", 0, 1, points=pt,
          labels=one)
    _propagate_both(jp, tp, js, ts)
    _both(jp, tp, js, ts, "add_new_points_or_box", 3, 1,
          points=np.array([[50.0, 70.0]], np.float32), labels=one)
    again = _propagate_both(jp, tp, js, ts)
    assert sorted(again) == list(range(6))
    for key in ("cond", "non_cond"):
        assert (set(ts["output_dict_per_obj"][0][key])
                == set(js["output_dict_per_obj"][0][key]))
    assert set(ts["output_dict_per_obj"][0]["cond"]) == {0, 3}


def test_non_overlap_and_cond_frame_selection_match_jax():
    rng = np.random.default_rng(0)
    m = rng.standard_normal((3, 16, 16)).astype(np.float32) * 12
    np.testing.assert_array_equal(
        tvideo.apply_non_overlapping_constraints(torch.as_tensor(m)).numpy(),
        np.asarray(jvideo.apply_non_overlapping_constraints(jnp.asarray(m))))
    cond = {t: {"t": t} for t in (0, 3, 4, 9, 15)}
    for frame in (1, 4, 8, 20):
        for cap in (-1, 2, 3, 7):
            assert (tvideo.select_closest_cond_frames(frame, cond, cap)
                    == jvideo.select_closest_cond_frames(frame, cond, cap))
