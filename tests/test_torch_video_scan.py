"""The port's chunked-scan tracker (`SAM2VideoPredictor._scan_plan` /
`_scan_step`) on the CPU in float32, on the tiny config and clips of
tests/test_torch_video.py.

The three scenarios of tests/test_video_scan.py (two objects on two
conditioning frames; temporal stride 2 in reverse; a 15-frame run in a
chunk of 8 and a tail of 7) go through the JAX package's scan path and the
port's, held within 2e-3 (the tolerance of tests/test_torch_video.py: the
two frameworks' float32 roundings carried through the memory recurrence),
and through the port's per-frame path, held within 1e-5 (the two paths run
the same operations on the same operands, and agree bit for bit on the
CPU). The JAX package's scan compiles once per shape and branch, and that is
most of this file's time, so each scenario runs once per module.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from no_time_to_train_tpu.models.matching.pipeline import _random_params_like
from no_time_to_train_tpu.models.sam2.model import SAM2 as JSAM2
from no_time_to_train_tpu.models.sam2 import video as jvideo
from no_time_to_train_tpu_torch.models.sam2.model import SAM2
from no_time_to_train_tpu_torch.models.sam2 import video as tvideo
from no_time_to_train_tpu_torch.utils.convert import sam2_state_dict

from test_torch_video import IMG, TOL, _frames, _tiny_cfg
from test_torch_video import one_torch_thread  # noqa: F401 (fixture)

SAME = dict(rtol=1e-5, atol=1e-5)
ONE = np.array([1], np.int32)

# name -> (config, frames, clip seed, prompts (frame, object, point), chunk,
# propagate_in_video arguments)
SCENARIOS = {
    "two_objects_two_cond": (
        dict(fill_hole_area=8), 18, 3,
        [(0, 1, [30.0, 60.0]), (0, 2, [95.0, 30.0]),
         (9, 1, [55.0, 60.0]), (9, 2, [95.0, 30.0])], 4, {}),
    "stride2_reverse": (
        dict(fill_hole_area=0, memory_temporal_stride_for_eval=2), 14, 5,
        [(13, 1, [70.0, 60.0])], 4, dict(start_frame_idx=13, reverse=True)),
    "chunk_and_tail": (
        dict(fill_hole_area=0), 16, 7, [(0, 1, [30.0, 60.0])], 8, {}),
}


@pytest.fixture(scope="module")
def weights():
    """One numpy-seeded weight set of the tiny config, as JAX params and as
    the port's state_dict (the scenarios' configs change the tracker's
    settings, not the weights' shapes)."""
    jm = JSAM2(_tiny_cfg())
    params = _random_params_like(
        lambda k: jm.init(k, jnp.zeros((1, IMG, IMG, 3)),
                          method=jm.init_everything),
        jax.random.PRNGKey(0), 0)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)
    sd = {k: torch.as_tensor(v) for k, v in sam2_state_dict(params).items()}
    return params, sd


def _port(weights, cfg, **kw):
    tm = SAM2(cfg)
    tm.load_state_dict(weights[1], strict=True)
    return tvideo.SAM2VideoPredictor(tm, device="cpu", **kw)


def _track(pred, frames, prompts, chunk, init=None, **kw):
    """Prompt one point per (frame, object), propagate; masks by frame as
    numpy, and the state."""
    pred.scan_chunk = chunk
    state = pred.init_state(frames, **(init or {}))
    for f, obj, xy in prompts:
        pred.add_new_points_or_box(state, f, obj,
                                   points=np.array([xy], np.float32),
                                   labels=ONE)
    masks = {t: np.asarray(m) for t, _, m in
             pred.propagate_in_video(state, **kw)}
    return masks, state


def _close(got, want, what, tol):
    assert list(got) == list(want), what
    for t in want:
        np.testing.assert_allclose(got[t], want[t], err_msg=f"{what} {t}",
                                   **tol)


@pytest.fixture(scope="module", params=list(SCENARIOS))
def scenario(request, weights):
    """One scenario through the JAX scan path, the port's scan path and the
    port's per-frame path."""
    cfg_kw, n, seed, prompts, chunk, kw = SCENARIOS[request.param]
    cfg = _tiny_cfg(**cfg_kw)
    frames = _frames(n, seed=seed)
    jp = jvideo.SAM2VideoPredictor(JSAM2(cfg), weights[0])
    tp = _port(weights, cfg)
    steps = []
    scan_step = tp._scan_step
    tp._scan_step = lambda s, *a: (steps.append(int(s.t)),
                                   scan_step(s, *a))[1]
    out = dict(jp=jp, tp=tp, frames=frames, prompts=prompts, chunk=chunk,
               kw=kw)
    out["jax"], out["jax_state"] = _track(jp, frames, prompts, chunk, **kw)
    out["scan"], out["scan_state"] = _track(tp, frames, prompts, chunk, **kw)
    out["scan_steps"] = list(steps)
    out["frame"], out["frame_state"] = _track(tp, frames, prompts, 0, **kw)
    assert len(steps) == len(out["scan_steps"])     # none on the frame path
    del tp._scan_step
    return out


def test_scan_matches_jax_scan(scenario):
    """Every frame of the port's scan path within 2e-3 of the JAX
    package's scan path; every tracked frame went through the scan step."""
    _close(scenario["scan"], scenario["jax"], "scan vs JAX scan", TOL)
    prompted = {f for f, _, _ in scenario["prompts"]}
    assert sorted(scenario["scan_steps"]) == sorted(
        set(scenario["scan"]) - prompted)


def test_scan_matches_per_frame_path(scenario):
    _close(scenario["scan"], scenario["frame"], "scan vs per-frame", SAME)


def test_writeback_matches_per_frame_path(scenario):
    """The scan's writeback leaves the per-frame path's non_cond keys, and
    its entries hold the same tensors."""
    got, want = scenario["scan_state"], scenario["frame_state"]
    for o in range(len(want["obj_id_to_idx"])):
        g = got["output_dict_per_obj"][o]["non_cond"]
        w = want["output_dict_per_obj"][o]["non_cond"]
        assert sorted(g) == sorted(w)
        assert sorted(g) == sorted(
            scenario["jax_state"]["output_dict_per_obj"][o]["non_cond"])
        for t in w:
            assert set(g[t]) == set(w[t])
            for k in w[t]:
                np.testing.assert_allclose(g[t][k].numpy(), w[t][k].numpy(),
                                           err_msg=f"{o} {t} {k}", **SAME)
    assert got["frames_already_tracked"] == want["frames_already_tracked"]


def test_per_frame_tail_seeded_by_writeback(weights):
    """A scanned run that stops at frame 9, then frames 10-15 on the
    per-frame path, which reads the memories the writeback left: the same
    masks as the per-frame path throughout."""
    _, n, seed, prompts, _, _ = SCENARIOS["chunk_and_tail"]
    tp = _port(weights, _tiny_cfg(fill_hole_area=0))
    frames = _frames(n, seed=seed)
    want, _ = _track(tp, frames, prompts, 0)
    got, state = _track(tp, frames, prompts, 8, max_frame_num_to_track=9)
    assert sorted(state["output_dict_per_obj"][0]["non_cond"]) == list(
        range(1, 10))
    tp.scan_chunk = 0
    got.update({t: np.asarray(m) for t, _, m in
                tp.propagate_in_video(state, start_frame_idx=10)})
    _close(got, want, "scan then per-frame", SAME)


def test_abandoned_scan_writes_back(weights):
    """A consumer that closes the generator after 3 frames: the frames of
    the two chunks dispatched so far (1-8 at a chunk of 4; the second is
    dispatched before the first yields) get their per-frame entries, equal
    to the per-frame path's; frames_already_tracked holds the yielded
    frames only."""
    _, n, seed, prompts, _, _ = SCENARIOS["chunk_and_tail"]
    tp = _port(weights, _tiny_cfg(fill_hole_area=0))
    frames = _frames(n, seed=seed)
    _, want = _track(tp, frames, prompts, 0)
    tp.scan_chunk = 4
    state = tp.init_state(frames)
    tp.add_new_points_or_box(state, 0, 1, points=[prompts[0][2]], labels=ONE)
    it = tp.propagate_in_video(state)
    assert [next(it)[0] for _ in range(3)] == [0, 1, 2]
    it.close()
    got = state["output_dict_per_obj"][0]["non_cond"]
    assert sorted(got) == list(range(1, 9))
    for t in got:
        for k, v in got[t].items():
            np.testing.assert_allclose(
                v.numpy(), want["output_dict_per_obj"][0]["non_cond"][t][k]
                .numpy(), err_msg=f"{t} {k}", **SAME)
    assert set(state["frames_already_tracked"]) == {0, 1, 2}


def test_interleaved_runs_of_one_key_raise(weights):
    """Two propagations with the same key share the step's buffers (and on
    the card its graph); the one that lost them raises at its next chunk
    instead of tracking on the other's memory, after writing back what it
    tracked."""
    _, n, seed, prompts, _, _ = SCENARIOS["chunk_and_tail"]
    tp = _port(weights, _tiny_cfg(fill_hole_area=0))
    frames = _frames(n, seed=seed)
    its = []
    for _ in range(2):
        state = tp.init_state(frames)
        tp.add_new_points_or_box(state, 0, 1, points=[prompts[0][2]],
                                 labels=ONE)
        its.append((tp.propagate_in_video(state), state))
    tp.scan_chunk = 4
    first, state = its[0]
    assert [next(first)[0] for _ in range(2)] == [0, 1]
    assert [next(its[1][0])[0] for _ in range(2)] == [0, 1]
    with pytest.raises(RuntimeError, match="took this run's buffers"):
        for _ in first:
            pass
    assert sorted(state["output_dict_per_obj"][0]["non_cond"]) == list(
        range(1, 9))


def test_video_res_on_scan_path(scenario):
    """output_video_res=True on the scan path: each chunk at the original
    video resolution (96 x 160), against the JAX package's scan path (the
    scenario's predictors, so the JAX scan is not compiled again); with
    non_overlap_masks, against the port's per-frame path. Where two
    objects' logits lie within float32 noise of each other (1e-5 apart on
    3 pixels of the first scenario's frame 1), which one the non-overlap
    keeps differs between the two frameworks, so the non-overlap itself is
    held to the JAX package's by tests/test_torch_video.py (bit for bit on
    logits without ties)."""
    jp, tp = scenario["jp"], scenario["tp"]
    args = (scenario["frames"], scenario["prompts"], scenario["chunk"],
            dict(video_height=96, video_width=160))
    kw = dict(output_video_res=True, **scenario["kw"])
    want, _ = _track(jp, *args, **kw)
    got, _ = _track(tp, *args, **kw)
    n_obj = len({obj for _, obj, _ in scenario["prompts"]})
    assert all(m.shape == (n_obj, 96, 160) for m in got.values())
    _close(got, want, "video res", TOL)
    tp.non_overlap_masks = True
    try:
        scan, _ = _track(tp, *args, **kw)
        frame, _ = _track(tp, *args[:2], 0, *args[3:], **kw)
    finally:
        tp.non_overlap_masks = False
    _close(scan, frame, "video res, non-overlap", SAME)
    if n_obj > 1:              # the non-overlap pushed losing objects down
        assert any(((scan[t] <= -10) & (got[t] > -10)).any() for t in got)


def test_bail_outs_take_the_per_frame_path(weights, monkeypatch):
    """The JAX package's conditions for the per-frame path: a clip held on
    the host, and more conditioning frames than max_cond_frames_in_attn (2
    here, 3 prompted); the scan step never runs, and the masks are the
    per-frame path's. Two conditioning frames stay on the scan path."""
    cfg = _tiny_cfg(fill_hole_area=0, max_cond_frames_in_attn=2)
    tp = _port(weights, cfg)
    frames = _frames(10, seed=2)
    three = [(0, 1, [30.0, 60.0]), (4, 1, [45.0, 60.0]),
             (8, 1, [55.0, 60.0])]
    want_host, _ = _track(tp, frames, three[:2], 0)
    want_cond, _ = _track(tp, frames, three, 0)
    steps = []
    scan_step = tp._scan_step
    monkeypatch.setattr(tp, "_scan_step",
                        lambda *a: (steps.append(1), scan_step(*a))[1])
    host, _ = _track(tp, frames, three[:2], 4, dict(store_on_device=False))
    over, _ = _track(tp, frames, three, 4)
    assert not steps
    _close(host, want_host, "clip on the host", SAME)
    _close(over, want_cond, "max_cond_frames_in_attn", SAME)
    scanned, _ = _track(tp, frames, three[:2], 4)
    assert len(steps) == 8                   # frames 1-3 and 5-9
    _close(scanned, want_host, "two conditioning frames", SAME)


def test_normalize_coords_matches_jax(scenario):
    """ROADMAP C.15: the port takes normalize_coords and, as the JAX
    package, ignores it: at a video of 96 x 160 (not the model's 128^2) a
    point stays in model-input pixels on both, with the flag on or off. The
    reference SAM2 would scale it from video pixels; this test holds the
    JAX package's behaviour, which the port follows (run on each scenario's
    predictors, whose decode is compiled already)."""
    jp, tp = scenario["jp"], scenario["tp"]
    frames = scenario["frames"]
    init = dict(video_height=96, video_width=160)
    pt = np.array([[100.0, 60.0]], np.float32)
    for normalize_coords in (True, False):
        js, ts = jp.init_state(frames, **init), tp.init_state(frames, **init)
        _, jids, jm = jp.add_new_points_or_box(
            js, 0, 1, points=pt, labels=ONE,
            normalize_coords=normalize_coords)
        _, tids, tm = tp.add_new_points_or_box(
            ts, 0, 1, points=pt, labels=ONE,
            normalize_coords=normalize_coords)
        assert list(tids) == list(jids) == [1]
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
        assert np.array_equal(ts["point_inputs_per_obj"][0][0][0], pt)
