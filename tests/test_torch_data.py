"""The port's data layer (`no_time_to_train_tpu_torch/data/`) against the JAX
package's on the same inputs: RLE, the COCO API, COCOeval, reference
sampling, the four dataset classes, result encoding, negative sampling,
TIDE counts and the video frame loader. Both read the same PNG files; the
port decodes and resizes them without PIL, so every dataset item must be
equal bit for bit."""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from no_time_to_train_tpu.data import coco_api as j_coco
from no_time_to_train_tpu.data import cocoeval as j_eval
from no_time_to_train_tpu.data import data_utils as j_utils
from no_time_to_train_tpu.data import datasets as j_ds
from no_time_to_train_tpu.data import few_shot_sampling as j_fss
from no_time_to_train_tpu.data import rle as j_rle
from no_time_to_train_tpu.data import tide as j_tide
from no_time_to_train_tpu.data import video_loader as j_video
from no_time_to_train_tpu.data.metainfo import METAINFO as J_METAINFO
from no_time_to_train_tpu_torch.data import coco_api as t_coco
from no_time_to_train_tpu_torch.data import cocoeval as t_eval
from no_time_to_train_tpu_torch.data import data_utils as t_utils
from no_time_to_train_tpu_torch.data import datasets as t_ds
from no_time_to_train_tpu_torch.data import few_shot_sampling as t_fss
from no_time_to_train_tpu_torch.data import rle as t_rle
from no_time_to_train_tpu_torch.data import tide as t_tide
from no_time_to_train_tpu_torch.data import video_loader as t_video
from no_time_to_train_tpu_torch.data.metainfo import METAINFO as T_METAINFO

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATS = [{"id": 1, "name": "person"}, {"id": 2, "name": "car"},
        {"id": 5, "name": "dog"}]


def _same(a, b, path="item"):
    """Equal nested dicts / lists / arrays, arrays bit for bit with their
    dtypes."""
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _polygon(cx, cy, r, n=7, phase=0.0):
    t = phase + np.arange(n) * 2 * np.pi / n
    return np.stack([cx + r * np.cos(t), cy + 0.8 * r * np.sin(t)],
                    1).ravel().round(2).tolist()


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    """6 PNG images of odd sizes, written by PIL; per image a polygon
    instance of each class, an uncompressed-RLE instance and, on two
    images, a crowd region."""
    root = tmp_path_factory.mktemp("coco")
    rng = np.random.default_rng(0)
    images, anns = [], []
    sizes = [(97, 131), (120, 88), (143, 150), (101, 117), (90, 160),
             (133, 99)]
    for i, (h, w) in enumerate(sizes):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        arr[: h // 2] //= 3                         # smooth-ish half
        Image.fromarray(arr).save(root / f"{i}.png")
        images.append({"id": 10 + i, "height": h, "width": w,
                       "file_name": f"{i}.png"})
        for k, cat in enumerate(CATS):
            poly = _polygon(22 + 24 * k + i, 30 + 5 * k, 13 + i, phase=i + k)
            xy = np.asarray(poly).reshape(-1, 2)
            x0, y0 = xy.min(0)
            x1, y1 = xy.max(0)
            anns.append({"id": len(anns) + 1, "image_id": 10 + i,
                         "category_id": cat["id"], "iscrowd": 0,
                         "bbox": [float(x0), float(y0), float(x1 - x0),
                                  float(y1 - y0)],
                         "area": float((x1 - x0) * (y1 - y0)),
                         "segmentation": [poly]})
        m = np.zeros((h, w), np.uint8)
        m[h - 40:h - 12, 15:60] = 1
        anns.append({"id": len(anns) + 1, "image_id": 10 + i,
                     "category_id": CATS[i % 3]["id"], "iscrowd": 0,
                     "bbox": [15.0, float(h - 40), 45.0, 28.0],
                     "area": float(m.sum()),
                     "segmentation": {"size": [h, w], "counts":
                                      j_rle.counts_from_mask(m)}})
        if i in (1, 4):
            m = np.zeros((h, w), np.uint8)
            m[5:35, w - 45:w - 5] = 1
            anns.append({"id": len(anns) + 1, "image_id": 10 + i,
                         "category_id": 1, "iscrowd": 1,
                         "bbox": [float(w - 45), 5.0, 40.0, 30.0],
                         "area": float(m.sum()),
                         "segmentation": j_rle.encode_mask(m)})
    ann_json = root / "ann.json"
    ann_json.write_text(json.dumps({"images": images, "annotations": anns,
                                    "categories": CATS}))
    return root, str(ann_json)


def _results(coco_set, seed=1):
    """Detections near the GT (jittered polygons, some off target) with
    compressed-RLE masks, as a test run exports them."""
    root, ann_json = coco_set
    gt = j_coco.COCO(ann_json)
    rng = np.random.default_rng(seed)
    res = []
    for ann in gt.dataset["annotations"]:
        if ann["iscrowd"]:
            continue
        info = gt.imgs[ann["image_id"]]
        m = gt.annToMask(ann)
        dy, dx = rng.integers(-4, 5, 2)
        m = np.roll(np.roll(m, dy, 0), dx, 1)
        if rng.random() < 0.3:
            m = np.roll(m, info["width"] // 2, 1)
        ys, xs = np.nonzero(m)
        cat = ann["category_id"] if rng.random() < 0.8 else CATS[
            int(rng.integers(0, 3))]["id"]
        res.append({"image_id": ann["image_id"], "category_id": cat,
                    "bbox": [float(xs.min()), float(ys.min()),
                             float(xs.max() - xs.min()),
                             float(ys.max() - ys.min())],
                    "score": float(rng.random()),
                    "segmentation": j_rle.encode_mask(m)})
    return res


def test_metainfo_is_the_same_registry():
    assert T_METAINFO == J_METAINFO


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (64, 48), (33, 97)])
def test_rle_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    masks = [np.zeros(shape, np.uint8), np.ones(shape, np.uint8),
             (rng.random(shape) > 0.5).astype(np.uint8),
             (rng.random(shape) > 0.97).astype(np.uint8)]
    for m in masks:
        enc = t_rle.encode_mask(m)
        assert enc == j_rle.encode_mask(m)
        counts = t_rle.counts_from_mask(m)
        assert counts == j_rle.counts_from_mask(m)
        assert t_rle.rle_to_string(counts) == j_rle.rle_to_string(counts)
        assert t_rle.string_to_counts(enc["counts"]) == counts
        np.testing.assert_array_equal(t_rle.decode_rle(enc), m)
        np.testing.assert_array_equal(
            t_rle.decode_rle({"size": list(shape), "counts": counts}), m)
        assert t_rle.area(enc) == j_rle.area(enc) == int(m.sum())
    encs = [j_rle.encode_mask(m) for m in masks]
    np.testing.assert_array_equal(
        t_rle.iou_rle(encs[2:], encs[:3], [0, 1, 0]),
        j_rle.iou_rle(encs[2:], encs[:3], [0, 1, 0]))
    np.testing.assert_array_equal(t_rle.merge_hw(encs, *shape),
                                  j_rle.merge_hw(encs, *shape))


def test_coco_api_masks_and_load_res_match_jax(coco_set):
    _, ann_json = coco_set
    jc, tc = j_coco.COCO(ann_json), t_coco.COCO(ann_json)
    for ann in jc.dataset["annotations"]:
        np.testing.assert_array_equal(tc.annToMask(ann), jc.annToMask(ann))
        assert tc.annToRLE(ann) == jc.annToRLE(ann)
    assert tc.getCatIds(catNms=["car", "dog"]) == jc.getCatIds(
        catNms=["car", "dog"])
    assert tc.getAnnIds(imgIds=[11], iscrowd=0) == jc.getAnnIds(
        imgIds=[11], iscrowd=0)
    assert sorted(tc.getImgIds(catIds=[2])) == sorted(jc.getImgIds(catIds=[2]))
    res = _results(coco_set)
    no_box = [{k: v for k, v in r.items() if k != "bbox"} for r in res[:5]]
    box_only = [{k: v for k, v in r.items() if k != "segmentation"}
                for r in res[5:9]]
    for dets in (res, no_box, box_only):
        jr, tr = jc.loadRes(dets), tc.loadRes(dets)
        assert tr.dataset == jr.dataset
        assert tr.anns == jr.anns


def test_cocoeval_stats_match_jax(coco_set):
    _, ann_json = coco_set
    res = _results(coco_set)
    for iou_type in ("bbox", "segm"):
        stats = []
        for coco_mod, eval_mod in ((j_coco, j_eval), (t_coco, t_eval)):
            gt = coco_mod.COCO(ann_json)
            ev = eval_mod.COCOeval(gt, gt.loadRes(res), iou_type)
            ev.evaluate()
            ev.accumulate()
            ev.summarize()
            stats.append(ev.stats)
        np.testing.assert_array_equal(stats[1], stats[0])
        assert (stats[0][:2] > 0).all()


def test_tide_and_false_positives_match_jax(coco_set):
    _, ann_json = coco_set
    res = _results(coco_set, seed=2)
    gt = j_coco.COCO(ann_json)
    for mode in ("bbox", "segm"):
        assert t_tide.tide_errors(t_coco.COCO(ann_json), res, mode) \
            == j_tide.tide_errors(gt, res, mode)
    anns = gt.loadAnns(gt.getAnnIds(imgIds=[12]))
    dets = [r for r in res if r["image_id"] == 12]
    assert t_utils.get_false_positives(dets, anns, [1, 2, 5]) \
        == j_utils.get_false_positives(dets, anns, [1, 2, 5])
    for ann in anns:
        assert t_utils.is_valid_annotation(ann, gt.imgs[12], 10, 2) \
            == j_utils.is_valid_annotation(ann, gt.imgs[12], 10, 2)


@pytest.mark.parametrize("multi", [False, True])
def test_sample_memory_dataset_writes_the_same_pkl(coco_set, tmp_path,
                                                   multi):
    _, ann_json = coco_set
    out = []
    for mod, tag in ((j_fss, "j"), (t_fss, "t")):
        path = tmp_path / f"{tag}.pkl"
        mod.sample_memory_dataset(ann_json, str(path), 3, remove_bad=False,
                                  allow_invalid=True, allow_duplicates=True,
                                  prefer_multi_instance=multi, seed=7)
        out.append(path.read_bytes())
    assert out[0] == out[1]


def test_sampling_module_entry_point(coco_set, tmp_path):
    """`python -m ...few_shot_sampling` writes what the JAX function
    writes. Its COCO branch keeps valid annotations only (boxes of 32
    pixels or more, 10 from the borders), so the boxes are widened here."""
    _, src = coco_set
    data = json.loads(open(src).read())
    for ann in data["annotations"]:
        ann["bbox"] = [12.0 + ann["id"] % 5, 12.0, 40.0, 40.0]
    ann_json = str(tmp_path / "valid.json")
    with open(ann_json, "w") as f:
        json.dump(data, f)
    got, want = tmp_path / "cli.pkl", tmp_path / "jax.pkl"
    subprocess.run([sys.executable, "-m",
                    "no_time_to_train_tpu_torch.data.few_shot_sampling",
                    "--n-shot", "1", "--out-path", str(got), "--seed", "4",
                    "--dataset", "coco", "--dataset-json", ann_json],
                   cwd=ROOT, check=True, capture_output=True, timeout=120)
    j_fss.sample_memory_dataset(ann_json, str(want), 1, remove_bad=True,
                                dataset="coco", seed=4)
    with open(got, "rb") as f, open(want, "rb") as g:
        refs = pickle.load(f)
        assert refs == pickle.load(g)
    assert sorted(refs) == [1, 2, 5]


@pytest.fixture(scope="module")
def memory_pkl(coco_set, tmp_path_factory):
    _, ann_json = coco_set
    path = tmp_path_factory.mktemp("pkl") / "refs.pkl"
    j_fss.sample_memory_dataset(ann_json, str(path), 2, remove_bad=False,
                                allow_invalid=True, seed=3)
    return str(path)


def _dataset_pair(name, coco_set, memory_pkl, **kw):
    root, ann_json = coco_set
    names = [c["name"] for c in CATS]
    if name in ("COCOMemoryFillCropDataset", "COCOMemoryFillDataset"):
        args = (str(root), ann_json, memory_pkl, 56, 2)
    else:
        args = (str(root), ann_json, 64)
    return (getattr(j_ds, name)(*args, cat_names=names, **kw),
            getattr(t_ds, name)(*args, cat_names=names, **kw))


@pytest.mark.parametrize("name,kw", [
    ("COCOMemoryFillCropDataset", {"context_ratio": 0.2}),
    ("COCOMemoryFillCropDataset", {"norm_img": True}),
    ("COCOMemoryFillDataset", {"semantic_ref": True}),
    ("COCORefTestDataset", {"with_query_points": True}),
    ("COCORefOracleTestDataset", {"norm_img": True}),
])
def test_dataset_items_equal_jax(coco_set, memory_pkl, name, kw):
    jd, td = _dataset_pair(name, coco_set, memory_pkl, **kw)
    assert len(td) == len(jd) > 0
    for i in range(len(jd)):
        _same(td[i], jd[i], f"{name}[{i}]")


def test_encode_results_and_evaluate_match_jax(coco_set, memory_pkl):
    jd, td = _dataset_pair("COCORefTestDataset", coco_set, memory_pkl)
    rng = np.random.default_rng(5)
    outs = []
    for img_id in jd.img_ids[:3]:
        info = jd.coco.imgs[img_id]
        masks = rng.random((4, info["height"], info["width"])) > 0.7
        outs.append(dict(img_id=img_id, scores=rng.random(4),
                         labels=rng.integers(0, 3, 4),
                         boxes=rng.random((4, 4)) * 50, masks=masks))
    enc = td.encode_results(outs)
    assert enc == jd.encode_results(outs)
    segs = [dict({k: v for k, v in o.items() if k != "masks"},
                 segs=[j_rle.encode_mask(m.astype(np.uint8))
                       for m in o["masks"]]) for o in outs]
    assert td.encode_results(segs) == enc
    got, want = td.evaluate(enc), jd.evaluate(enc)
    for k in ("bbox", "segm"):
        np.testing.assert_array_equal(got[k], want[k])


def test_sample_negative_writes_the_same_files(coco_set, memory_pkl,
                                               tmp_path):
    jd, td = _dataset_pair("COCORefTestDataset", coco_set, memory_pkl)
    res = _results(coco_set, seed=3)
    for r in res:          # push every detection off its object
        r["bbox"] = [0.0, 0.0, 3.0, 3.0]
    files = []
    for ds, tag in ((jd, "j"), (td, "t")):
        pkl, js = tmp_path / f"{tag}.pkl", tmp_path / f"{tag}.json"
        ds.sample_negative(res, str(pkl), str(js), sample_num=2)
        files.append((pkl.read_bytes(), json.loads(js.read_text())))
    assert files[1] == files[0]


def test_load_image_matches_jax_on_png(coco_set):
    root, _ = coco_set
    for i, size in enumerate((None, 64, (50, 70), (200, 180))):
        path = str(root / f"{i}.png")
        for norm in (False, True):
            got = t_ds.load_image(path, size, normalize=norm)
            want = j_ds.load_image(path, size, normalize=norm)
            _same(list(got), list(want), f"{path} {size} {norm}")


@pytest.mark.parametrize("async_loading", [False, True])
def test_video_frames_match_jax(tmp_path, async_loading):
    rng = np.random.default_rng(2)
    for t in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)
                        ).save(tmp_path / f"{t}.png")
    got, gh, gw = t_video.load_video_frames(str(tmp_path), image_size=32,
                                            async_loading_frames=async_loading)
    want, jh, jw = j_video.load_video_frames(str(tmp_path), image_size=32)
    assert (gh, gw) == (jh, jw) == (40, 52)
    assert got.shape == want.shape
    for t in range(3):
        np.testing.assert_array_equal(got[t], want[t])
