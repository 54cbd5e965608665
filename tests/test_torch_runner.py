"""The port's CLI runner against the JAX package's, end to end on the CPU.

One fabricated COCO-format data set (PNG files, polygon instances of two
classes, blank support images), tiny SAM2 / DINO presets registered in both
packages, and one set of weight files: the port's seeded initialisation
written as a SAM2 `.pt` and a DINO directory with a `.bin`, which both
runners load. The JAX CLI (`run_lightning.main`) and the port's
(`no_time_to_train_tpu_torch.cli.main --device cpu`) each run
fill_memory -> postprocess_memory -> test, and the negative chain
test_support -> sample_negative -> fill_memory_neg -> postprocess_memory_neg
-> test, once per module. Both finalize with the native library (the one
upsample path, ROADMAP C.4).
"""
import json
import pickle

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import run_lightning
from no_time_to_train_tpu.config import presets as jpresets
from no_time_to_train_tpu.data.datasets import (
    COCORefTestDataset as JTestDataset)
from no_time_to_train_tpu_torch import cli
from no_time_to_train_tpu_torch.config import presets as tpresets
from no_time_to_train_tpu_torch.data import rle
from no_time_to_train_tpu_torch.data.datasets import COCORefTestDataset
from no_time_to_train_tpu_torch.models.matching.pipeline import (
    MatchingConfig, NoAMGMatcher)
from no_time_to_train_tpu_torch.utils import native

SAM_NAME, ENC_NAME = "sam2_tiny_runner.yaml", "dino_tiny_runner"
SAM_FIELDS = dict(
    embed_dim=32, num_heads=1, stages=(1, 1, 1, 1), global_att_blocks=(2,),
    window_pos_embed_bkg_spatial_size=(2, 2), window_spec=(4, 2, 4, 2),
    backbone_channel_list=(256, 128, 64, 32), image_size=128)
ENC_ARGS = (ENC_NAME, 28, 14, 32, 1, 2, "local")
CATS = [{"id": 3, "name": "car"}, {"id": 7, "name": "train"}]
SCORE_ATOL = 1e-4
MASK_DIFF = 1e-3          # share of a mask's pixels that may differ


def _polygon(cx, cy, r, n=9, phase=0.0):
    t = phase + np.arange(n) * 2 * np.pi / n
    rr = r * (1.0 + 0.15 * np.cos(3 * t))
    return np.stack([cx + rr * np.cos(t), cy + rr * np.sin(t)], 1).ravel()


def _dataset(root, rng):
    """4 train/test images with one instance of each class, 3 blank support
    images. Returns (image dir, annotation json, support json)."""
    img_dir = root / "imgs"
    img_dir.mkdir()
    images, anns = [], []
    for i in range(7):
        h, w = (112, 128) if i % 2 == 0 else (120, 104)
        arr = (rng.random((h, w, 3)) * 70).astype(np.uint8)
        images.append({"id": i + 1, "height": h, "width": w,
                       "file_name": f"{i:03d}.png"})
        if i < 4:
            for k, cat in enumerate(CATS):
                cx, cy = (33 + 38 * k, 40 + 6 * i)
                poly = _polygon(cx, cy, 19, phase=0.3 * i + k)
                xy = poly.reshape(-1, 2)
                x0, y0 = xy.min(0)
                x1, y1 = xy.max(0)
                yy, xx = np.mgrid[0:h, 0:w]
                inside = (xx - cx) ** 2 + (yy - cy) ** 2 < 17 ** 2
                arr[inside] = [200, 60 + 120 * k, 40]
                anns.append({"id": len(anns) + 1, "image_id": i + 1,
                             "category_id": cat["id"],
                             "bbox": [float(x0), float(y0), float(x1 - x0),
                                      float(y1 - y0)],
                             "area": float((x1 - x0) * (y1 - y0)),
                             "iscrowd": 0, "segmentation": [poly.tolist()]})
        Image.fromarray(arr).save(img_dir / images[-1]["file_name"])
    ann_json = root / "ann.json"
    ann_json.write_text(json.dumps({"images": images[:4], "annotations": anns,
                                    "categories": CATS}))
    support_json = root / "support.json"
    support_json.write_text(json.dumps({"images": images[4:],
                                        "annotations": [],
                                        "categories": CATS}))
    return str(img_dir), str(ann_json), str(support_json)


def _weights(root):
    """The port's seeded weights as a SAM2 .pt and a DINO .bin directory."""
    m = NoAMGMatcher(tpresets.SAM2_PRESETS[SAM_NAME],
                     tpresets.ENCODER_PRESETS[ENC_NAME], MatchingConfig(),
                     n_classes=2, memory_length=2, seed=5, device="cpu")
    sam_pt = root / "sam2_tiny.pt"
    torch.save({"model": m.sam2.state_dict()}, sam_pt)
    dino_dir = root / "dino_tiny"
    dino_dir.mkdir()
    torch.save(m.dino.state_dict(), dino_dir / "pytorch_model.bin")
    return str(sam_pt), str(dino_dir)


def _config(root, img_dir, ann_json, support_json, sam_pt, dino_dir, pkl):
    def data(**kw):        # fresh lists: shared ones would dump as aliases
        return dict(name="coco", root=img_dir, json_file=ann_json,
                    norm_img=False, cat_names=[c["name"] for c in CATS], **kw)

    cfg = {
        "seed_everything": 42,
        "model": {"init_args": {
            "model_cfg": {
                "name": "matching_baseline_noAMG",
                "sam2_cfg_file": SAM_NAME, "sam2_ckpt_path": sam_pt,
                "sam2_infer_cfgs": {
                    "points_per_side": 4, "testing_point_bs": 8,
                    "iou_thr": 0.0, "nms_thr": 0.5, "num_out_instance": 5,
                    "kmeans_k": 2, "n_pca_components": 2,
                    "cls_num_per_mask": -1, "with_negative_refs": True},
                "encoder_cfg": {"name": ENC_NAME},
                "encoder_ckpt_path": dino_dir,
                "memory_bank_cfg": {"enable": True, "category_num": 2,
                                    "length": 2, "length_negative": 2}},
            "dataset_cfgs": {
                "fill_memory": data(memory_pkl=pkl, image_size=28,
                                    memory_length=2, context_ratio=0.2),
                "support": dict(data(image_size=128), json_file=support_json),
                "test": data(image_size=128)},
            "data_load_cfgs": {"workers": 2}}},
        "trainer": {"devices": 1},
    }
    path = root / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _chain(main, cfg, root, tag, extra, support_ds):
    """Both chains of one package through its CLI. Returns the exports and
    the negative-sampling outputs."""
    d = root / tag
    d.mkdir()
    base = ["test", "--config", cfg, "--trainer.logger.save_dir", str(d)]
    p = {k: str(d / k) for k in ("m1", "m2", "m3", "m4", "support.pkl",
                                 "neg.pkl", "neg.json", "test.json",
                                 "test_neg.json", "support.json")}

    def run(mode, *args):
        main(base + ["--model.test_mode", mode, *args] + extra)

    run("fill_memory", "--out_path", p["m1"])
    run("postprocess_memory", "--ckpt_path", p["m1"], "--out_path", p["m2"])
    run("test", "--ckpt_path", p["m2"], "--export_result", p["test.json"])
    run("test_support", "--ckpt_path", p["m2"], "--out_support_res",
        p["support.pkl"], "--export_result", p["support.json"])
    with open(p["support.pkl"], "rb") as f:
        support = pickle.load(f)
    support_ds.sample_negative(support, p["neg.pkl"], p["neg.json"],
                               sample_num=2)
    run("fill_memory_neg", "--ckpt_path", p["m2"], "--out_path", p["m3"],
        "--out_neg_pkl", p["neg.pkl"], "--out_neg_json", p["neg.json"])
    run("postprocess_memory_neg", "--ckpt_path", p["m3"], "--out_path",
        p["m4"])
    run("test", "--ckpt_path", p["m4"], "--export_result", p["test_neg.json"])
    out = {k: json.load(open(p[k])) for k in ("test.json", "test_neg.json",
                                               "support.json", "neg.json")}
    with open(p["neg.pkl"], "rb") as f:
        out["neg.pkl"] = pickle.load(f)
    out["dir"] = d
    return out


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    root = tmp_path_factory.mktemp("runner")
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
        from no_time_to_train_tpu_torch.data.few_shot_sampling import (
            sample_memory_dataset)
        pkl = str(root / "refs.pkl")
        sample_memory_dataset(ann_json, pkl, 2, remove_bad=False, seed=3)
        cfg = _config(root, img_dir, ann_json, support_json, sam_pt,
                      dino_dir, pkl)
        names = [c["name"] for c in CATS]
        jax_out = _chain(run_lightning.main, cfg, root, "jax", [],
                         JTestDataset(img_dir, support_json, 128,
                                      cat_names=names))
        port_out = _chain(cli.main, cfg, root, "port", ["--device", "cpu"],
                          COCORefTestDataset(img_dir, support_json, 128,
                                             cat_names=names))
        yield jax_out, port_out
    finally:
        for table, key, _ in added:
            table.pop(key, None)


def _same_records(got, want):
    assert len(got) == len(want) > 0
    assert [r["image_id"] for r in got] == [r["image_id"] for r in want]
    assert [r["category_id"] for r in got] == [r["category_id"]
                                               for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], atol=SCORE_ATOL)
    for g, w in zip(got, want):
        mg = rle.decode_rle(g["segmentation"]).astype(bool)
        mw = rle.decode_rle(w["segmentation"]).astype(bool)
        assert mg.shape == mw.shape
        assert (mg != mw).mean() <= MASK_DIFF


def test_native_finalize_pins_the_upsample():
    assert native.has_finalize()


@pytest.mark.parametrize("export", ["test.json", "support.json",
                                    "test_neg.json"])
def test_port_cli_exports_match_jax_cli(chains, export):
    jax_out, port_out = chains
    _same_records(port_out[export], jax_out[export])


def test_negative_sampling_writes_the_same_references(chains):
    jax_out, port_out = chains
    assert port_out["neg.pkl"] == jax_out["neg.pkl"]
    got, want = port_out["neg.json"], jax_out["neg.json"]
    assert got["images"] == want["images"]
    assert got["categories"] == want["categories"]
    _same_records(got["annotations"], want["annotations"])
    for g, w in zip(got["annotations"], want["annotations"]):
        assert {k: v for k, v in g.items() if k != "score"} \
            == {k: v for k, v in w.items() if k != "score"}
    assert sum(len(v) for v in port_out["neg.pkl"].values()) == 4


def test_runner_writes_metrics_and_analysis_dumps(chains):
    _, port_out = chains
    d = port_out["dir"]
    rows = open(d / "metrics_log.csv").read().splitlines()
    assert rows[0].startswith("images,mean_time_s,fps,bbox_AP")
    assert len(rows) == 1 + 3          # test, test_support, test again
    for name in ("scalars_all.pkl", "triplets_all.pkl"):
        with open(d / name, "rb") as f:
            assert len(pickle.load(f)) > 0


def test_cli_without_device_needs_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["test", "--config", str(tmp_path / "unused.yaml"),
                  "--model.test_mode", "test"])


def test_cli_parses_like_run_lightning():
    argv = ["test", "--config", "c.yaml", "--model.test_mode", "test",
            "--model.init_args.model_cfg.sam2_infer_cfgs.iou_thr=0.3",
            "--ckpt_path", "x.ckpt", "--device", "cpu"]
    args, overrides = cli.parse_args(argv)
    jargs, joverrides = run_lightning.parse_args(argv[:-2])
    assert overrides == joverrides
    assert args == dict(jargs, device="cpu")
    tree = {"a": {"b": 1}}
    cli._set_dotted(tree, "a.c.d", 2)
    assert tree == {"a": {"b": 1, "c.d": 2}}


def test_runner_refuses_what_is_not_ported(monkeypatch):
    """Both matcher options of the JAX package build (`decoder_impl:
    factored`, `encoder_quant: int8`, on the tiny presets) and reach the
    matcher; an unknown value of either raises ValueError, and so does a CUDA
    run that would drive more GPUs than the process sees, before anything is
    built (data parallelism itself: tests/test_torch_parallel.py; the online
    visualization: tests/test_torch_frontends.py)."""
    from no_time_to_train_tpu_torch.ops.quant import Int8Linear
    from no_time_to_train_tpu_torch.runner import MatcherRunner
    monkeypatch.setitem(tpresets.SAM2_PRESETS, SAM_NAME,
                        tpresets.Sam2Config(**SAM_FIELDS))
    monkeypatch.setitem(tpresets.ENCODER_PRESETS, ENC_NAME,
                        tpresets.EncoderConfig(*ENC_ARGS))
    base = {"sam2_cfg_file": SAM_NAME, "encoder_cfg": {"name": ENC_NAME}}
    built = MatcherRunner(dict(base, sam2_infer_cfgs={
        "decoder_impl": "factored", "encoder_quant": "int8"}), {},
        device="cpu").matcher
    assert built.matching.decoder_impl == "factored"
    assert built.matching.encoder_quant == "int8"
    assert isinstance(built.dino.encoder.layer[0].mlp.fc1, Int8Linear)
    assert isinstance(built.sam2.image_encoder.trunk.blocks[0].mlp.layers[0],
                      Int8Linear)
    for key, bad in (("decoder_impl", "bogus"), ("encoder_quant", "int4")):
        with pytest.raises(ValueError, match=key):
            MatcherRunner(dict(base, sam2_infer_cfgs={key: bad}), {},
                          device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="devices=2"):
        MatcherRunner(base, {}, devices=2, device="cuda")
