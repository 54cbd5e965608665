"""The port's host tools against the JAX package's, on the CPU: LVIS
evaluation, the dataset converters (with `sam_bbox_to_segm_batch` on a tiny
SAM2 image predictor), the dataset tools, the memory poller's parse
(ROADMAP C.16), the profiling helpers and `print_dict`.

The inputs are those of tests/test_lvis_eval.py and
tests/test_converters_vis.py. Every host-only tool gives the JAX function's
output exactly: both run the same numpy and Python steps.

Mutation tried (in a copy of the repo): dropping the neg-category filter of
the port's `LVISEval._prepare` makes `test_lvis_eval_matches_jax` fail
(the category-3 detection then counts as a false positive).
"""
import json
import os
import pickle
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from no_time_to_train_tpu.data import converters as jconv
from no_time_to_train_tpu.data import dataset_tools as jtools
from no_time_to_train_tpu.data import metainfo as jmeta
from no_time_to_train_tpu.data.coco_api import COCO as JCOCO
from no_time_to_train_tpu.data.lvis_eval import LVISEval as JLVISEval
from no_time_to_train_tpu.models.sam2.image_predictor import (
    SAM2ImagePredictor as JPredictor)
from no_time_to_train_tpu.utils import misc as jmisc
from no_time_to_train_tpu.utils import profiling as jprof
from no_time_to_train_tpu_torch.data import converters as tconv
from no_time_to_train_tpu_torch.data import dataset_tools as ttools
from no_time_to_train_tpu_torch.data import lvis_eval as tlvis
from no_time_to_train_tpu_torch.data import metainfo as tmeta
from no_time_to_train_tpu_torch.data import rle
from no_time_to_train_tpu_torch.data.coco_api import COCO as TCOCO
from no_time_to_train_tpu_torch.data.coco_api import rasterize_polygons
from no_time_to_train_tpu_torch.models.sam2.image_predictor import (
    SAM2ImagePredictor)
from no_time_to_train_tpu_torch.utils import memory_poller, misc, profiling

from test_converters_vis import _toy_coco
from test_lvis_eval import _mk
from test_torch_image_predictor import TINY, sam2_pair

# sam_bbox_to_segm_batch: the share of an image's pixels on which the
# port's mask and the JAX package's may differ. The two predictors' logits
# agree to 1e-4 (test_torch_image_predictor.py), so only pixels whose
# logit lies that close to the threshold can flip; the share read on these
# inputs is 0 for every box.
MASK_DIFF = 1e-3


def _json(path):
    with open(path) as f:
        return json.load(f)


# ------------------------------------------------------------------ LVIS


def _lvis_set(tmp_path):
    """tests/test_lvis_eval.py's set (image 1 annotates category 3 as
    absent) plus an image 2 with a category-3 instance, so that a
    category-3 detection on image 1 would be a false positive of a
    category that has ground truth. Returns the GT path."""
    _mk(tmp_path)
    path = tmp_path / "lvis.json"
    gt = _json(path)
    gt["images"].append({"id": 2, "height": 32, "width": 32,
                         "file_name": "b.jpg", "neg_category_ids": [],
                         "not_exhaustive_category_ids": []})
    gt["annotations"].append(
        {"id": 3, "image_id": 2, "category_id": 3, "bbox": [4, 4, 12, 12],
         "area": 144, "iscrowd": 0,
         "segmentation": [[4, 4, 16, 4, 16, 16, 4, 16]]})
    path.write_text(json.dumps(gt))
    return str(path)


def _lvis_dets():
    """tests/test_lvis_eval.py's detections (the category-3 one on image 1,
    which annotates the category as absent, scored highest) and a hit on
    image 2's category-3 instance."""
    return [{"image_id": 1, "category_id": 1, "bbox": [2, 2, 10, 10],
             "score": 0.9},
            {"image_id": 1, "category_id": 2, "bbox": [16, 16, 10, 10],
             "score": 0.8},
            {"image_id": 1, "category_id": 3, "bbox": [0, 0, 5, 5],
             "score": 0.95},
            {"image_id": 2, "category_id": 3, "bbox": [4, 4, 12, 12],
             "score": 0.7}]


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_lvis_eval_matches_jax(tmp_path, iou_type):
    """LVISEval's stats (maxDets 300, APr/APc/APf, the neg-category filter)
    equal the JAX package's on `_lvis_set`; segm on the GT polygons as
    detection RLEs, one of them shifted by 2 pixels."""
    gt_path = _lvis_set(tmp_path)
    dets = _lvis_dets()
    if iou_type == "segm":
        polys = {(a["image_id"], a["category_id"]): a["segmentation"]
                 for a in _json(gt_path)["annotations"]}
        polys[1, 3] = [[0, 0, 5, 0, 5, 5, 0, 5]]
        polys[1, 2] = [[18, 18, 28, 18, 28, 28, 18, 28]]
        dets = [dict(d, segmentation=rle.encode_mask(rasterize_polygons(
            polys[d["image_id"], d["category_id"]], 32, 32).astype(
                np.uint8))) for d in dets]
    stats = []
    for COCO, LVISEval in ((JCOCO, JLVISEval), (TCOCO, tlvis.LVISEval)):
        gt = COCO(gt_path)
        ev = LVISEval(gt, gt.loadRes([dict(d) for d in dets]), iou_type)
        assert ev.params.maxDets == [300]
        ev.evaluate()
        ev.accumulate()
        stats.append(ev.summarize())
    assert stats[1] == stats[0]
    # the negatively annotated category-3 detection is dropped, not a
    # false positive ranked above the category's one hit
    assert stats[1]["APc"] == pytest.approx(1.0, abs=1e-12)


def test_lvis_eval_cli_matches_jax(tmp_path):
    """`python -m no_time_to_train_tpu_torch.data.lvis_eval` (its `main`)
    on an exported results file gives the JAX entry's stats; an empty
    export returns None."""
    from no_time_to_train_tpu.data import lvis_eval as jlvis
    gt_path = _lvis_set(tmp_path)
    res = tmp_path / "res.json"
    res.write_text(json.dumps(_lvis_dets()))
    argv = ["--gt", gt_path, "--results", str(res),
            "--iou-type", "bbox"]
    assert tlvis.main(argv) == jlvis.main(argv)
    res.write_text("[]")
    assert tlvis.main(argv) is None


# ------------------------------------------------------------ converters


def _both(name, *args, **kw):
    """(JAX output, port output) of the converter `name`."""
    return getattr(jconv, name)(*args, **kw), getattr(tconv, name)(*args,
                                                                     **kw)


def test_coco_to_pkl_matches_jax(tmp_path):
    p, _ = _toy_coco(tmp_path)
    want, got = (f(p, str(tmp_path / f"{tag}.pkl"), target_examples=10)
                 for tag, f in (("j", jconv.coco_to_pkl),
                                ("t", tconv.coco_to_pkl)))
    assert got == want and len(got[1]) >= 10
    with open(tmp_path / "t.pkl", "rb") as f:
        assert pickle.load(f) == want


def test_sample_sub_dataset_matches_jax(tmp_path):
    p, _ = _toy_coco(tmp_path, n_imgs=5)
    want, got = _both("sample_sub_dataset", p, str(tmp_path / "sub.json"), 2,
                      seed=3)
    assert got == want and len(got["images"]) == 2
    assert _json(tmp_path / "sub.json") == want


def test_lvis_fixers_match_jax(tmp_path):
    data = {"images": [{"id": 1, "coco_url":
                        "http://images.cocodataset.org/val2017/000123.jpg"},
                       {"id": 2, "file_name": "kept.jpg"}],
            "annotations": [{"id": 5, "segmentation": None},
                            {"id": 6, "segmentation": [[1, 2, 3, 4]]}],
            "categories": []}
    full = {"annotations": [{"id": 5, "segmentation": [[0, 0, 4, 0, 4, 4]]},
                            {"id": 6, "segmentation": None}]}
    (tmp_path / "l.json").write_text(json.dumps(data))
    (tmp_path / "full.json").write_text(json.dumps(full))
    want, got = _both("lvis_add_filename", str(tmp_path / "l.json"),
                      str(tmp_path / "o.json"))
    assert got == want
    assert [im["file_name"] for im in got["images"]] == ["000123.jpg",
                                                         "kept.jpg"]
    want, got = _both("lvis_fix_minival_segm", str(tmp_path / "full.json"),
                      str(tmp_path / "l.json"), str(tmp_path / "fixed.json"))
    assert got == want
    assert [a["segmentation"] for a in got["annotations"]] == \
        [[[0, 0, 4, 0, 4, 4]], [[1, 2, 3, 4]]]


@pytest.mark.parametrize("case", ["plain", "crowd", "reference_bug"])
def test_inst_to_segm_eval_matches_jax(tmp_path, case):
    """The three cases of test_converters_vis.py: a perfect prediction, a
    crowd GT that counts as background, and the reference's index bug
    (replicated on request) with a full and an empty prediction set."""
    p, data = _toy_coco(tmp_path, n_imgs=1, per_img=1)
    seg = data["annotations"][0]["segmentation"]
    preds = [{"image_id": 1, "category_id": 1, "score": 0.9,
              "segmentation": seg}]
    kw_list = [{}]
    if case == "crowd":
        crowd = rle.encode_mask(
            np.pad(np.ones((8, 8), np.uint8), ((20, 4), (20, 4))))
        data["annotations"].append(
            {"id": 99, "image_id": 1, "category_id": 1,
             "bbox": [20, 20, 8, 8], "area": 64.0, "iscrowd": 1,
             "segmentation": crowd})
        preds.append({"image_id": 1, "category_id": 1, "score": 0.8,
                      "segmentation": crowd})
    if case == "reference_bug":
        data["categories"] = [{"id": 1, "name": "person"},
                              {"id": 2, "name": "dog"}]
        kw_list = [dict(class_split="_bugtest_split", **extra)
                   for extra in ({}, {"replicate_reference_bug": True})]
    gt = tmp_path / "gt2.json"
    gt.write_text(json.dumps(data))
    split = {"_bugtest_split": ("person",)}
    jmeta.METAINFO.update(split)
    tmeta.METAINFO.update(split)
    try:
        for pred_set in (preds, []):
            pp = tmp_path / "pred.json"
            pp.write_text(json.dumps(pred_set))
            for kw in kw_list:
                want, got = _both("coco_inst_to_segm_eval", str(gt),
                                  str(pp), **kw)
                assert got["miou"] == want["miou"] or \
                    (np.isnan(got["miou"]) and np.isnan(want["miou"]))
                assert got["per_class_iou"].keys() == \
                    want["per_class_iou"].keys()
    finally:
        del jmeta.METAINFO["_bugtest_split"], tmeta.METAINFO["_bugtest_split"]
    want, got = _both("coco_inst_to_segm_eval", str(gt),
                      str(tmp_path / "pred.json"))
    expect = {"plain": 0.0, "crowd": 0.0, "reference_bug": 0.0}[case]
    assert got["miou"] == want["miou"] == expect     # the empty set last


def test_pascal_voc_to_coco_matches_jax(tmp_path):
    (tmp_path / "Annotations").mkdir()
    objs = "".join(
        f"<object><name>{n}</name><difficult>{d}</difficult><bndbox>"
        f"<xmin>{x}</xmin><ymin>21</ymin><xmax>{x + 40}</xmax>"
        f"<ymax>61</ymax></bndbox></object>"
        for n, d, x in (("dog", 0, 11), ("cat", 1, 5), ("unicorn", 0, 7)))
    (tmp_path / "Annotations" / "im0.xml").write_text(
        "<annotation><filename>im0.jpg</filename><size><width>100</width>"
        f"<height>80</height><depth>3</depth></size>{objs}</annotation>")
    split = tmp_path / "trainval.txt"
    split.write_text("im0\n")
    for difficult in (False, True):
        want, got = _both("pascal_voc_to_coco", str(tmp_path), str(split),
                          str(tmp_path / "voc.json"),
                          use_difficult=difficult)
        assert got == want == _json(tmp_path / "voc.json")
        assert len(got["annotations"]) == 1 + difficult


def test_strip_filename_dirs_and_zeroshot_split_match_jax(tmp_path):
    data = {"images": [{"id": 1, "file_name": "VOC2007/JPEGImages/a.jpg"},
                       {"id": 2, "file_name": "b.jpg"}],
            "annotations": [], "categories": []}
    src = tmp_path / "long.json"
    src.write_text(json.dumps(data))
    want, got = _both("strip_filename_dirs", [str(src)],
                      [str(tmp_path / "short.json")])
    assert got == want
    cats = [{"id": 1, "name": "person"}, {"id": 16, "name": "cat"},
            {"id": 10, "name": "traffic light"}]
    inst = {"images": [{"id": i, "file_name": f"{i}.jpg"} for i in (1, 2, 3)],
            "annotations": [{"id": i, "image_id": i, "category_id": c}
                            for i, c in ((1, 1), (2, 16), (3, 10))],
            "categories": cats}
    src = tmp_path / "instances.json"
    src.write_text(json.dumps(inst))
    outs = {}
    for tag, mod in (("j", jconv), ("t", tconv)):
        names = mod.coco_zeroshot_split_export(str(src), str(src),
                                               str(tmp_path / tag))
        outs[tag] = {n: _json(tmp_path / tag / n) for n in names}
    assert outs["t"] == outs["j"] and len(outs["t"]) == 6


def test_sam_bbox_to_segm_batch_matches_jax(tmp_path):
    """Box annotations -> masks through the image predictor, one box at a
    time: the port's `SAM2ImagePredictor` against the JAX package's on one
    port init carried across by `convert_sam2`. Every annotation gains an
    RLE; each mask differs from the JAX one on at most MASK_DIFF of the
    pixels and equals `predict(box=..., multimask_output=False)` called
    directly."""
    rng = np.random.default_rng(2)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    images, anns = [], []
    for i, (h, w) in enumerate(((80, 96), (96, 72))):
        arr = (rng.random((h, w, 3)) * 60).astype(np.uint8)
        arr[10:50, 14:60] = [210, 60, 60]
        Image.fromarray(arr).save(img_dir / f"{i}.png")
        images.append({"id": i + 1, "height": h, "width": w,
                       "file_name": f"{i}.png"})
        for j, box in enumerate(([14, 10, 46, 40], [5, 52, 30, 20])):
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": 1, "bbox": box, "area": 1.0,
                         "iscrowd": 0})
    src = tmp_path / "boxes.json"
    src.write_text(json.dumps({"images": images, "annotations": anns,
                               "categories": [{"id": 1, "name": "x"}]}))
    jm, params, tm = sam2_pair(TINY)
    want = jconv.sam_bbox_to_segm_batch(str(src), str(img_dir),
                                        str(tmp_path / "j.json"),
                                        JPredictor(jm, params))
    pred = SAM2ImagePredictor(tm)
    got = tconv.sam_bbox_to_segm_batch(str(src), str(img_dir),
                                       str(tmp_path / "t.json"), pred)
    assert _json(tmp_path / "t.json") == got
    assert len(got["annotations"]) == 4
    for g, w in zip(got["annotations"], want["annotations"]):
        mg = rle.decode_rle(g["segmentation"]).astype(bool)
        mw = rle.decode_rle(w["segmentation"]).astype(bool)
        assert mg.shape == mw.shape == (images[g["image_id"] - 1]["height"],
                                        images[g["image_id"] - 1]["width"])
        assert (mg != mw).mean() <= MASK_DIFF
    # the last image's boxes against direct predictor calls
    from no_time_to_train_tpu_torch.data.datasets import load_image
    img, _, _ = load_image(str(img_dir / "1.png"))
    pred.set_image(img)
    for a in got["annotations"][2:]:
        x, y, w, h = a["bbox"]
        masks, _, _ = pred.predict(box=[x, y, x + w, y + h],
                                   multimask_output=False)
        assert a["segmentation"] == rle.encode_mask(masks[0, 0])


# --------------------------------------------------------- dataset tools


def test_dataset_tools_match_jax(tmp_path):
    """get_classes, make_custom_dataset (with image copies),
    merge_coco_datasets, sample_memory_semantic_ref and
    rename_files_sequential: the JAX functions' outputs and files."""
    p, data = _toy_coco(tmp_path, n_imgs=4, per_img=2)
    assert ttools.get_classes(p) == jtools.get_classes(p) == ["person"]
    src = tmp_path / "src"
    src.mkdir()
    for im in data["images"]:
        (src / im["file_name"]).write_bytes(b"png")
    sel = {"reference": {"person": [1, 2]}, "targets": [3, 4]}
    out = {}
    for tag, mod in (("j", jtools), ("t", ttools)):
        res = mod.make_custom_dataset(p, str(tmp_path / tag), sel,
                                      img_src_dir=str(src))
        files = sorted(os.listdir(tmp_path / tag / "images"))
        out[tag] = (res, files)
    assert out["t"] == out["j"]
    assert out["t"][1] == ["0.png", "1.png"]
    assert ttools.merge_coco_datasets([p, p], str(tmp_path / "mt.json")) == \
        jtools.merge_coco_datasets([p, p], str(tmp_path / "mj.json"))
    assert ttools.sample_memory_semantic_ref(
        p, str(tmp_path / "st.pkl"), 2, seed=4) == \
        jtools.sample_memory_semantic_ref(p, str(tmp_path / "sj.pkl"), 2,
                                          seed=4)
    for tag, mod in (("j", jtools), ("t", ttools)):
        d = tmp_path / f"rename_{tag}"
        d.mkdir()
        for im in data["images"]:
            (d / im["file_name"]).write_bytes(b"x")
        out[tag] = (mod.rename_files_sequential(str(d), p,
                                                str(d / "out.json"),
                                                prefix="v_"),
                    sorted(os.listdir(d)))
    assert out["t"] == out["j"]


def test_download_dataset_from_a_local_archive(tmp_path, monkeypatch):
    """`download_dataset` on a `file://` zip (no network): fetched,
    unpacked and deleted as the JAX function does."""
    archive = tmp_path / "ann.zip"
    with zipfile.ZipFile(archive, "w") as z:
        z.writestr("annotations/instances.json", "{}")
    url = archive.as_uri()
    for mod in (jtools, ttools):
        monkeypatch.setattr(mod, "COCO2017_URLS", [url])
    got = ttools.download_dataset(save_dir=str(tmp_path / "t"), delete=True,
                                  threads=1)
    want = jtools.download_dataset(save_dir=str(tmp_path / "j"), delete=True,
                                   threads=1)
    assert [x.name for x in got] == [x.name for x in want] == ["ann.zip"]
    for tag in ("t", "j"):
        d = tmp_path / tag
        assert sorted(str(x.relative_to(d)) for x in d.rglob("*")) == \
            ["annotations", "annotations/instances.json"]


# ----------------------------------------------------- poller, profiling


SMI = "0, 1234, 81559\n1, 0, 81559\n\n"


def test_memory_poller_parses_nvidia_smi_and_writes_rows(tmp_path,
                                                         monkeypatch):
    """The parse of `nvidia-smi --query-gpu=index,memory.used,memory.total
    --format=csv,noheader,nounits` (canned here), and `main` writing one
    row per GPU and reading (ROADMAP C.16: device-wide numbers, not an
    allocator of the poller's own)."""
    assert memory_poller.parse(SMI) == [(0, 1234, 81559), (1, 0, 81559)]
    assert memory_poller.QUERY[1:] == [
        "--query-gpu=index,memory.used,memory.total",
        "--format=csv,noheader,nounits"]
    monkeypatch.setattr(memory_poller, "sample",
                        lambda: memory_poller.parse(SMI))
    sleeps = []

    def sleep(s):
        sleeps.append(s)
        if len(sleeps) == 2:
            raise KeyboardInterrupt

    monkeypatch.setattr(memory_poller.time, "sleep", sleep)
    out = tmp_path / "mem.csv"
    with pytest.raises(KeyboardInterrupt):
        memory_poller.main(["--out", str(out), "--interval", "0.5"])
    rows = out.read_text().splitlines()
    assert rows[0] == "t,index,used_mib,total_mib"
    assert [r.split(",")[1:] for r in rows[1:]] == \
        [["0", "1234", "81559"], ["1", "0", "81559"]] * 2
    assert sleeps == [0.5, 0.5]


def test_profiling_timer_trace_and_memory_stats(tmp_path, capsys):
    """`Timer` reports as the JAX package's (same lines, same dict on the
    same times), `trace` writes a Chrome trace that names the profiled op,
    and `device_memory_stats` of a CPU device is empty."""
    timers = (profiling.Timer(), jprof.Timer())
    calls = []
    for t in timers:
        with t.step(sync=lambda: calls.append(1)):
            pass
    timers[1].times = list(timers[0].times)
    reports = [t.report() for t in timers]
    lines = capsys.readouterr().out.splitlines()
    assert reports[0] == reports[1] and calls == [1, 1]
    half = len(lines) // 2
    assert lines[:half] == lines[half:]
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = _json(tmp_path / "tr" / "trace.json")
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert profiling.device_memory_stats("cpu") == {}


def test_print_dict_matches_jax(capsys):
    d = {"a": 1, "b": {"c": [1, 2], "d": {"e": "x"}}}
    jmisc.print_dict(d)
    want = capsys.readouterr().out
    misc.print_dict(d)
    assert capsys.readouterr().out == want
