"""The port's front ends against the JAX package's, on the CPU at tiny
widths in float32: the runner's online visualization and `vis_memory`,
`scripts/eval_video_olive`, the `sam2_video` backend of
`eval_sam3_video_olive`, the `nttt` backend of `eval_sam3_olive_dispersion`,
`examples/demo_single_image`, the SAM2 side of the box-prompt example and
`golden_ap_check`.

One data set and one set of weights serve every test: the fabricated
COCO-format set of tests/test_torch_runner.py (PNGs, two classes) and the
port's seeded initialisation written as a SAM2 `.pt` and a DINO directory,
which both packages load (the JAX package through its checkpoint readers,
`utils/torch_convert.convert_sam2` and `models/dino.convert_hf_dinov2`).

Tolerances:
- exports and records: ids and labels equal, scores within 1e-4, each mask
  equal on all but 0.1 % of its pixels (tests/test_torch_runner.py's
  bands);
- the video logits: 2e-3 absolute and relative (tests/test_torch_video.py's
  band for a tracked frame);
- visualization panels: bit for bit outside the label text boxes (both
  fonts) and outside the pixels where the two exports' masks differ;
- `vis_memory`'s panels from the two runners: the original and the k-means
  overlay bit for bit, the PCA overlay within 2 gray levels (the two
  frameworks' encoder features differ by float32 rounding, which can move
  a projection across a level; a k-means colour could only change where
  two centres tie within that rounding, and none does at this 2 x 2 grid).
  Reading on this data: no pixel of any panel differs.
"""
import functools
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

import run_lightning
from no_time_to_train_tpu.config import presets as jpresets
from no_time_to_train_tpu.data.coco_api import COCO as JCOCO
from no_time_to_train_tpu.models.matching import pipeline as jpipeline
from no_time_to_train_tpu.models.sam2.image_predictor import (
    SAM2ImagePredictor as JImagePredictor)
from no_time_to_train_tpu.models.sam2.model import SAM2 as JSAM2
from no_time_to_train_tpu.utils.checkpoint import (
    load_sam2_torch_checkpoint as j_load_sam2)
from no_time_to_train_tpu_torch import cli
from no_time_to_train_tpu_torch.config import presets as tpresets
from no_time_to_train_tpu_torch.data import rle
from no_time_to_train_tpu_torch.data import visualization as tvis
from no_time_to_train_tpu_torch.data.coco_api import COCO
from no_time_to_train_tpu_torch.data.datasets import COCORefOracleTestDataset
from no_time_to_train_tpu_torch.data.few_shot_sampling import (
    sample_memory_dataset)
from no_time_to_train_tpu_torch.data.image_io import read_rgb
from no_time_to_train_tpu_torch.examples import demo_single_image as tdemo
from no_time_to_train_tpu_torch.examples import (
    sam2_vs_sam3_box_prompt as tbox)
from no_time_to_train_tpu_torch.models.matching import pipeline as tpipeline
from no_time_to_train_tpu_torch.runner import MatcherRunner
from no_time_to_train_tpu_torch.scripts import (
    eval_sam3_olive_dispersion as tdisp)
from no_time_to_train_tpu_torch.scripts import eval_sam3_video_olive as tv3
from no_time_to_train_tpu_torch.scripts import eval_video_olive as tvo
from no_time_to_train_tpu_torch.scripts import golden_ap_check as tgold
from no_time_to_train_tpu_torch.tools import plot_reference_images as tplot

import examples.demo_single_image as jdemo
import scripts.eval_sam3_olive_dispersion as jdisp
import scripts.eval_sam3_video_olive as jv3
import scripts.eval_video_olive as jvo
from test_torch_runner import (CATS, ENC_ARGS, ENC_NAME, MASK_DIFF,
                               SAM_FIELDS, SAM_NAME, SCORE_ATOL, _config,
                               _dataset, _same_records, _weights)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
PCA_LEVELS = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops per frame on one intra-op thread (as in
    tests/test_torch_video.py): beside the other test processes a pool of
    threads to wake per op is several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Tiny presets in both packages, the data set, the weights and the
    runner's YAML."""
    root = tmp_path_factory.mktemp("frontends")
    added = [(jpresets.SAM2_PRESETS, SAM_NAME,
              jpresets.Sam2Config(**SAM_FIELDS)),
             (tpresets.SAM2_PRESETS, SAM_NAME,
              tpresets.Sam2Config(**SAM_FIELDS)),
             (jpresets.ENCODER_PRESETS, ENC_NAME,
              jpresets.EncoderConfig(*ENC_ARGS)),
             (tpresets.ENCODER_PRESETS, ENC_NAME,
              tpresets.EncoderConfig(*ENC_ARGS))]
    for table, key, val in added:
        table[key] = val
    try:
        img_dir, ann_json, support_json = _dataset(
            root, np.random.default_rng(0))
        sam_pt, dino_dir = _weights(root)
        pkl = str(root / "refs.pkl")
        sample_memory_dataset(ann_json, pkl, 2, remove_bad=False, seed=3)
        cfg = _config(root, img_dir, ann_json, support_json, sam_pt,
                      dino_dir, pkl)
        yield types.SimpleNamespace(root=root, img_dir=img_dir,
                                    ann_json=ann_json, sam_pt=sam_pt,
                                    dino_dir=dino_dir, pkl=pkl, cfg=cfg)
    finally:
        for table, key, _ in added:
            table.pop(key, None)


# --------------------------------------------------------------- the runner
def _runs(main, w, tag, extra):
    """fill -> postprocess -> test with and without online_vis ->
    vis_memory through one package's CLI, in a directory of its own (the
    panels go to ./results_analysis). The bank keeps 3 PCA components: the
    PCA panel draws them as RGB."""
    d = w.root / tag
    d.mkdir()
    base = ["test", "--config", w.cfg, "--trainer.logger.save_dir", str(d),
            "--model.init_args.model_cfg.sam2_infer_cfgs.n_pca_components",
            "3"]
    p = {k: str(d / k) for k in ("m1", "m2", "off.json", "on.json")}
    cwd = os.getcwd()
    os.chdir(d)
    try:
        def run(mode, *args):
            main(base + ["--model.test_mode", mode, *args] + extra)

        run("fill_memory", "--out_path", p["m1"])
        run("postprocess_memory", "--ckpt_path", p["m1"], "--out_path",
            p["m2"])
        run("test", "--ckpt_path", p["m2"], "--export_result", p["off.json"])
        run("test", "--ckpt_path", p["m2"], "--export_result", p["on.json"],
            "--model.init_args.model_cfg.test.online_vis", "True")
        run("vis_memory", "--ckpt_path", p["m2"])
    finally:
        os.chdir(cwd)
    return d, {k: json.load(open(p[k])) for k in ("off.json", "on.json")}


@pytest.fixture(scope="module")
def vis_runs(world):
    return (_runs(run_lightning.main, world, "jax", []),
            _runs(cli.main, world, "port", ["--device", "cpu"]))


def _texts_boxes(boxes, texts, x_off):
    draw = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    out = []
    for box, text in zip(boxes, texts):
        xy = (float(box[0]) + 2, max(0, float(box[1]) - 12))
        jb = draw.textbbox(xy, text)
        tb = tvis.text_box(xy, text)
        out += [(int(np.floor(jb[0])), int(np.floor(jb[1])),
                 int(np.ceil(jb[2])), int(np.ceil(jb[3]))), tb]
    return [(x0 + x_off, y0, x1 + x_off, y1) for x0, y0, x1, y1 in out]


def _pred_labels(records, thr, names, cat_inds, x_off):
    kept = [r for r in records if r["score"] >= thr]
    boxes = [[x, y, x + bw, y + bh] for x, y, bw, bh in
             (r["bbox"] for r in kept)]
    texts = [f"{names[cat_inds[r['category_id']]]} {r['score']:.2f}"
             for r in kept]
    return _texts_boxes(boxes, texts, x_off), kept


def test_online_vis_panels_match_jax(world, vis_runs):
    """The same panel files; every pixel equal outside the label boxes and
    outside the pixels where the two exports' masks differ; and the port's
    export with the visualization on is its export with it off."""
    (jdir, jout), (tdir, tout) = vis_runs
    assert tout["on.json"] == tout["off.json"]
    _same_records(tout["on.json"], jout["on.json"])
    names = [c["name"] for c in CATS]
    ds = COCORefOracleTestDataset(world.img_dir, world.ann_json, 128,
                                  cat_names=names)
    panels = sorted(os.listdir(tdir / "results_analysis" / "coco"))
    assert panels == sorted(os.listdir(jdir / "results_analysis" / "coco"))
    assert len(panels) == len(ds) == 4
    for i in range(len(ds)):
        item = ds[i]
        info = item["target_img_info"]
        h, w = info["ori_height"], info["ori_width"]
        name = info["file_name"]
        got = read_rgb(str(tdir / "results_analysis" / "coco" / name))
        want = np.asarray(Image.open(jdir / "results_analysis" / "coco"
                                     / name).convert("RGB"))
        skip = []
        for cat, e in item["tar_anns_by_cat"].items():
            boxes = [b * np.array([w / 128, h / 128] * 2)
                     for b in e["bboxes"]]
            skip += _texts_boxes(boxes, [names[cat]] * len(boxes), 0)
        recs = {}
        for tag, out in (("j", jout), ("t", tout)):
            rs = [r for r in out["on.json"] if r["image_id"] == info["id"]]
            lb, recs[tag] = _pred_labels(rs, 0.5, names, ds.cat_ids_to_inds,
                                         w + 5)
            skip += lb
        keep = np.ones(got.shape[:2], bool)
        for x0, y0, x1, y1 in skip:
            keep[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = False
        for rj, rt in zip(recs["j"], recs["t"]):
            diff = (rle.decode_rle(rj["segmentation"]).astype(bool)
                    != rle.decode_rle(rt["segmentation"]).astype(bool))
            keep[:, w + 5:][diff] = False
        assert keep.mean() > 0.5
        assert not ((got != want).any(-1) & keep).any(), name


def test_online_vis_on_replicas_matches_one_device(world, vis_runs,
                                                   tmp_path):
    """The data-parallel test loop draws the same panels and exports the
    same records as the one-device loop: two CPU replicas, finalize
    workers asked for (the visualization keeps the binary masks in
    process, so the pool stays off)."""
    (_, _), (tdir, tout) = vis_runs
    export = str(tmp_path / "dp.json")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        cli.main(["test", "--config", world.cfg, "--trainer.logger.save_dir",
                  str(tmp_path), "--model.test_mode", "test",
                  "--model.init_args.model_cfg.sam2_infer_cfgs."
                  "n_pca_components", "3", "--ckpt_path", str(tdir / "m2"),
                  "--export_result", export,
                  "--model.init_args.model_cfg.test.online_vis", "True",
                  "--trainer.devices", "2",
                  "--model.init_args.data_load_cfgs.finalize_workers", "2",
                  "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert json.load(open(export)) == tout["on.json"]
    names = sorted(os.listdir(tdir / "results_analysis" / "coco"))
    assert sorted(os.listdir(tmp_path / "results_analysis" / "coco")) \
        == names
    for name in names:
        np.testing.assert_array_equal(
            read_rgb(str(tmp_path / "results_analysis" / "coco" / name)),
            read_rgb(str(tdir / "results_analysis" / "coco" / name)))


def test_vis_memory_panels_match_jax(world, vis_runs):
    """One panel per reference with the same file names; the original and
    the k-means overlay bit for bit, the PCA overlay within PCA_LEVELS
    (module docstring)."""
    (jdir, _), (tdir, _) = vis_runs
    files = sorted(os.listdir(tdir / "results_analysis" / "memory_vis"))
    assert files == sorted(os.listdir(jdir / "results_analysis"
                                      / "memory_vis"))
    assert len(files) == 4 and all(f.endswith(".png") for f in files)
    for f in files:
        got = read_rgb(str(tdir / "results_analysis" / "memory_vis" / f))
        want = np.asarray(Image.open(jdir / "results_analysis" / "memory_vis"
                                     / f).convert("RGB"))
        assert got.shape == want.shape
        w = (got.shape[1] - 10) // 3
        np.testing.assert_array_equal(got[:, :w], want[:, :w])
        pca = np.abs(got[:, 2 * w + 10:].astype(int)
                     - want[:, 2 * w + 10:].astype(int))
        assert pca.max() <= PCA_LEVELS, f
        km = (got[:, w + 5:2 * w + 5] != want[:, w + 5:2 * w + 5]).any(-1)
        assert not km.any(), (f, km.mean())


def test_runner_accepts_online_vis():
    """The online visualization is ported: the runner takes it and its
    score threshold (the refusal that tests/test_torch_runner.py held
    before the port had it)."""
    base = {"sam2_cfg_file": SAM_NAME, "encoder_cfg": {"name": ENC_NAME}}
    added = [(tpresets.SAM2_PRESETS, SAM_NAME,
              tpresets.Sam2Config(**SAM_FIELDS)),
             (tpresets.ENCODER_PRESETS, ENC_NAME,
              tpresets.EncoderConfig(*ENC_ARGS))]
    for table, key, val in added:
        table.setdefault(key, val)
    r = MatcherRunner(dict(base, online_vis=True, vis_thr=0.3), {},
                      device="cpu")
    assert r.online_vis and r.vis_thr == 0.3
    r = MatcherRunner(base, {}, device="cpu")
    assert not r.online_vis and r._vis_dir({"name": "coco"}) is None


# ---------------------------------------------------------- video harnesses
@pytest.fixture(scope="module")
def video_pair(world):
    return (jvo.build_predictor(SAM_NAME, world.sam_pt),
            tvo.build_predictor(SAM_NAME, world.sam_pt, device="cpu"))


def test_propagate_one_query_matches_jax(world, video_pair):
    jpred, tpred = video_pair
    with open(world.pkl, "rb") as f:
        memory = __import__("pickle").load(f)
    supports = tvo.load_supports(world.ann_json, world.img_dir, memory, 2,
                                 128)
    query = tvo.load_image(os.path.join(world.img_dir, "003.png"),
                           image_size=128)[0]
    for imgs, masks in supports.values():
        want = np.asarray(jvo.propagate_one_query(jpred, imgs, masks, query))
        got = tvo.propagate_one_query(tpred, imgs, masks, query)
        assert got.shape == want.shape == (2, 32, 32)
        np.testing.assert_allclose(got.float().numpy(), want, **LOGIT_TOL)


def test_eval_video_olive_main_matches_jax(world, video_pair, tmp_path,
                                           monkeypatch):
    jpred, tpred = video_pair
    monkeypatch.setattr(jvo, "build_predictor", lambda *a, **k: jpred)
    monkeypatch.setattr(tvo, "build_predictor", lambda *a, **k: tpred)
    args = ["--test-json", world.ann_json, "--test-root", world.img_dir,
            "--memory-pkl", world.pkl, "--train-json", world.ann_json,
            "--train-root", world.img_dir, "--n-shot", "2",
            "--max-images", "2", "--sam2-cfg", SAM_NAME]
    monkeypatch.setattr(sys, "argv", ["x"] + args + [
        "--out-json", str(tmp_path / "j.json")])
    jvo.main()
    out = tvo.main(args + ["--out-json", str(tmp_path / "t.json"),
                           "--device", "cpu"])
    want = json.load(open(tmp_path / "j.json"))
    assert json.load(open(tmp_path / "t.json")) == out["results"]
    _same_records(out["results"], want)
    assert len(out["seconds"]) == 2 and set(out["stats"]) == {"bbox", "segm"}


def _olive_layout(world, base):
    droot = base / "data"
    (droot / "annotations").mkdir(parents=True)
    os.symlink(world.img_dir, droot / "train2017")
    os.symlink(world.img_dir, droot / "val2017")
    for split in ("train2017", "val2017"):
        shutil.copy(world.ann_json,
                    droot / "annotations" / f"instances_{split}.json")
    return droot


def test_sam2_video_harness_matches_jax(world, tmp_path, monkeypatch):
    """eval_sam3_video_olive --backend sam2_video in both packages on the
    harness's data_root layout (tests/test_analysis_layer.py), the JAX
    run's sampled supports handed to the port's run."""
    droot = _olive_layout(world, tmp_path)
    args = ["--shots", "1", "--seed", "0", "--backend", "sam2_video",
            "--data_root", str(droot), "--class_split", "default_classes",
            "--image_size", "128", "--sam2_cfg", SAM_NAME, "--sam2_ckpt",
            world.sam_pt, "--max_queries", "2", "--evaluate_coco"]
    for tag in ("j", "t"):
        (tmp_path / tag).mkdir()
    monkeypatch.chdir(tmp_path / "j")
    monkeypatch.setattr(sys, "argv", ["x"] + args + [
        "--output_dir", str(tmp_path / "j" / "out")])
    jv3.main()
    shutil.copytree(tmp_path / "j" / "work_dirs", tmp_path / "t" / "work_dirs")
    monkeypatch.chdir(tmp_path / "t")
    out = tv3.main(args + ["--output_dir", str(tmp_path / "t" / "out"),
                           "--device", "cpu"])
    want = json.load(open(tmp_path / "j" / "out" / "sam3_predictions.json"))
    got = json.load(open(tmp_path / "t" / "out" / "sam3_predictions.json"))
    assert got == out["predictions"]
    _same_records(got, want)
    runtime = json.load(open(tmp_path / "t" / "out" / "sam3_runtime.json"))
    jruntime = json.load(open(tmp_path / "j" / "out" / "sam3_runtime.json"))
    assert set(runtime) == set(jruntime)
    assert runtime["num_queries"] == 2 and runtime["fps"] > 0
    assert runtime["peak_vram_mib"] is None
    assert set(out["stats"]) == {"bbox", "segm"}


# ------------------------------------------------------- dispersion, nttt
@pytest.fixture
def small_grid(monkeypatch):
    """The matchers the dispersion backend and the demo build take a 16^2
    point grid (one decode chunk) and keep every mask by predicted IoU:
    at random weights the default 0.4 keeps none."""
    for mod in (jpipeline, tpipeline, jdemo, tdemo):
        monkeypatch.setattr(mod, "MatchingConfig", functools.partial(
            mod.MatchingConfig, points_per_side=16, iou_thr=0.0))


def test_nttt_backend_matches_jax_and_keeps_no_bank(world, small_grid):
    """Two episodes, then the same two in reverse order, in both packages:
    each mask within the runner's band of the JAX package's, and the port's
    first episode the same mask both times, bit for bit (every episode
    starts from a zero bank)."""
    args = types.SimpleNamespace(
        sam2_cfg=SAM_NAME, sam2_ckpt=world.sam_pt, encoder=ENC_NAME,
        encoder_ckpt=world.dino_dir, image_size=128, shots="1,2", seed=0,
        device="cpu")
    jcoco, tcoco = JCOCO(world.ann_json), COCO(world.ann_json)
    jrun = jdisp.build_nttt_backend(args, jcoco)
    trun = tdisp.build_nttt_backend(args)
    episodes = [([1], 2), ([3, 4], 1)]

    def load(mod, coco, ep):
        support = [mod.load_image_and_gt(coco, world.img_dir, i, 3)[:2]
                   for i in ep[0]]
        return support, mod.load_image_and_gt(coco, world.img_dir, ep[1],
                                              3)[0]

    got, want = [], []
    for ep in episodes + episodes[::-1]:
        want.append(jrun(*load(jdisp, jcoco, ep)))
        got.append(trun(*load(tdisp, tcoco, ep)))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == bool
        assert (g != w).mean() <= MASK_DIFF
    np.testing.assert_array_equal(got[0], got[3])
    np.testing.assert_array_equal(got[1], got[2])
    assert any(g.any() for g in got)


def test_dispersion_main_runs_episodes(world, tmp_path, small_grid):
    out = tdisp.main(["--coco_json", world.ann_json, "--img_dir",
                      world.img_dir, "--sam2_cfg", SAM_NAME, "--sam2_ckpt",
                      world.sam_pt, "--encoder", ENC_NAME, "--encoder_ckpt",
                      world.dino_dir, "--image_size", "128", "--shots", "1",
                      "--episodes", "1", "--out_json",
                      str(tmp_path / "d.json"), "--device", "cpu"])
    assert out["errors"] == []
    assert sorted(out["final"][1]) == ["car", "train"]
    assert all(len(v) == 1 for v in out["final"][1].values())
    assert json.load(open(tmp_path / "d.json"))["1"] == {
        k: [float(x) for x in v] for k, v in out["final"][1].items()}


# ------------------------------------------------------------- examples
def _ref_mask(world, tmp_path):
    m = np.zeros((112, 128), np.uint8)     # wide: DINO's grid here is 2^2
    m[8:100, 4:90] = 255
    path = str(tmp_path / "ref_mask.png")
    Image.fromarray(m).save(path)
    return os.path.join(world.img_dir, "000.png"), path


def test_demo_single_image_matches_jax(world, tmp_path, monkeypatch,
                                      small_grid):
    ref, mask = _ref_mask(world, tmp_path)
    args = ["--ref-image", ref, "--ref-mask", mask, "--query-image",
            os.path.join(world.img_dir, "002.png"), "--sam2-cfg", SAM_NAME,
            "--sam2-ckpt", world.sam_pt, "--encoder", ENC_NAME,
            "--encoder-ckpt", world.dino_dir]
    monkeypatch.setattr(sys, "argv", ["x"] + args + [
        "--out", str(tmp_path / "j.png")])
    jdemo.main()
    fin, path = tdemo.main(args + ["--out", str(tmp_path / "t.png"),
                                   "--device", "cpu"])
    got = read_rgb(path)
    want = np.asarray(Image.open(tmp_path / "j.png").convert("RGB"))
    assert got.shape == want.shape == (112, 128, 3)
    assert len(fin["scores"]) > 0
    assert (got != want).any(-1).mean() <= MASK_DIFF


def test_box_prompt_sam2_side_matches_jax(world, tmp_path):
    """The port's run_sam2 against the JAX package's SAM2ImagePredictor
    driven as the notebook drives it: one box, multimask_output=True, the
    mask of the highest predicted IoU. (The JAX example's own run_sam2 cannot
    run: it hands the predictor a config where it takes a model, and an
    image in 0-255 where it takes [0, 1].)"""
    img_path = os.path.join(world.img_dir, "001.png")
    image = read_rgb(img_path)
    box = [10.0, 15.0, 70.0, 80.0]
    cfg = jpresets.SAM2_PRESETS[SAM_NAME]
    jpred = JImagePredictor(JSAM2(cfg), j_load_sam2(world.sam_pt, cfg))
    jpred.set_image(image.astype(np.float32) / 255.0)
    masks, ious, _ = jpred.predict(box=np.asarray(box, np.float32),
                                   multimask_output=True)
    best = int(np.argmax(ious[0]))
    mask, iou = tbox.run_sam2(image, box, SAM_NAME, world.sam_pt,
                              device="cpu")
    assert abs(iou - float(ious[0, best])) <= SCORE_ATOL
    assert mask.shape == image.shape[:2]
    assert (mask != masks[0, best]).mean() <= MASK_DIFF
    got, got_iou, path = tbox.main(
        ["--image", img_path, "--box", *map(str, box), "--sam2-cfg",
         SAM_NAME, "--sam2-ckpt", world.sam_pt, "--out",
         str(tmp_path / "b.png"), "--device", "cpu"])
    np.testing.assert_array_equal(got, mask)
    assert read_rgb(path).shape == (image.shape[0], 2 * image.shape[1] + 5, 3)


# ------------------------------------------------------------ golden AP
CONFIG = os.path.join(ROOT, "configs", "coco_fewshot_10shot_Sam2L.yaml")


def test_golden_prereq_guard_lists_missing(tmp_path):
    """check_prereqs reports every missing file; a satisfied set is
    empty (tests/test_golden_ap.py)."""
    import yaml
    missing = tgold.check_prereqs(CONFIG, dino_ckpt=None)
    assert any("dino_ckpt" in m for m in missing)
    f = tmp_path / "x.bin"
    f.write_bytes(b"0")
    cfg = {"model": {"init_args": {
        "model_cfg": {"sam2_ckpt_path": str(f)},
        "dataset_cfgs": {
            "fill_memory": {"root": str(tmp_path), "json_file": str(f)},
            "test": {"root": str(tmp_path), "json_file": str(f)}}}}}
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(cfg))
    assert tgold.check_prereqs(str(p), dino_ckpt=str(f)) == []


def test_golden_compare_tolerance():
    row = {"bbox_AP": "0.366", "segm_AP": "0.345"}
    ok, lines = tgold.compare(row, {"bbox": 0.368, "segm": 0.342},
                              tolerance_points=0.3)
    assert ok and len(lines) == 2
    ok, _ = tgold.compare(row, {"bbox": 0.368, "segm": 0.342},
                          tolerance_points=0.2)
    assert not ok


def test_golden_skips_cleanly_without_data(capsys):
    rc = tgold.main(["--config", CONFIG, "--device", "cpu"])
    assert rc == 0 and "SKIPPED" in capsys.readouterr().out
    assert tgold.main(["--config", CONFIG, "--strict", "--device",
                       "cpu"]) == 3


def test_golden_runs_the_pipeline_through_the_cli(world, tmp_path):
    """With every prerequisite present, main runs the four stages through
    the port's CLI and holds the metrics row to the expected AP: an anchor
    of -1 fails (exit 1) and the row's own AP passes."""
    res = str(tmp_path / "res")
    argv = ["--config", world.cfg, "--dino-ckpt", world.dino_dir,
            "--shots", "2", "--seed", "3", "--class-split",
            "default_classes", "--results-dir", res, "--device", "cpu"]
    assert tgold.main(argv + ["--expected-bbox", "-1"]) == 1
    import csv
    row = list(csv.DictReader(open(os.path.join(res, "metrics_log.csv"))))[-1]
    assert tgold.compare(row, {"bbox": float(row["bbox_AP"]),
                               "segm": float(row["segm_AP"])}, 0.0)[0]
    assert os.path.exists(os.path.join(res, "results_2shot_3seed.json"))


# ------------------------------------------------- every entry wants CUDA
ENTRIES = [
    (tvo.main, ["--test-json", "x", "--test-root", "x", "--memory-pkl", "x",
                "--train-json", "x", "--train-root", "x"]),
    (tv3.main, []),
    (tdisp.main, []),
    (tdemo.main, ["--ref-image", "x", "--ref-mask", "x", "--query-image",
                  "x"]),
    (tbox.main, ["--image", "x", "--box", "0", "0", "1", "1"]),
    (tgold.main, ["--config", CONFIG]),
]


@pytest.mark.parametrize("entry,argv", ENTRIES,
                         ids=[e.__module__.rsplit(".", 1)[-1]
                              for e, _ in ENTRIES])
def test_entry_without_device_needs_cuda(monkeypatch, entry, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        entry(argv)


def test_plot_reference_images_runs_as_a_module(world, tmp_path):
    out = tplot.main(["--json_path", world.ann_json, "--image_dir",
                      world.img_dir, "--output_dir", str(tmp_path)])
    assert [os.path.basename(p) for p in out] == [
        "ref_000.png", "ref_001.png", "ref_002.png", "ref_003.png"]
