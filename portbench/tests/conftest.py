"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with tiny
configurations (Hiera-T at 128^2 + DINOv2-S at 70^2, float32, an 8 x 8
grid, 3 classes x 2 shots; the same with a four-layer DINOv3 at 64^2, plain
or gated) and a tiny traffic mix, added as files and manifest entries only.

    python -m pytest portbench/tests -q

Tests marked `cuda` need an NVIDIA GPU and skip without one:
`python -m pytest -m cuda portbench/tests` on the card.
"""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_LIMITS = {"dino_cos": 1e-6, "fpn_cos": 1e-6, "decode_iou": 1e-5,
               "decode_rel": 2e-4, "mask_rel": 2e-3,
               "score_gap": 1e-4, "tail_gap": 1e-4, "finalize_err": 1e-3}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped without one)")


def tiny_config():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "sam2l_dinov2l.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny"
    cfg["program"] = {"sam2_cfg": "sam2_hiera_t.yaml",
                      "encoder_cfg": "dinov2_small",
                      "sam2_overrides": {"image_size": 128},
                      "encoder_overrides": {"img_size": 70}}
    cfg["topology"]["hiera"] = {
        "embed_dim": 96, "num_heads": 1, "stages": [1, 2, 7, 2],
        "global_att_blocks": [5, 7, 9], "window_spec": [8, 4, 14, 7],
        "window_pos_embed_bkg_spatial_size": [7, 7], "q_pool": 3,
        "backbone_channel_list": [768, 384, 192, 96], "d_model": 256,
        "fpn_top_down_levels": [2, 3], "scalp": 1, "image_size": 128}
    cfg["topology"]["dino"] = {"img_size": 70, "patch_size": 14, "dim": 384,
                               "depth": 12, "heads": 6, "mlp_ratio": 4}
    cfg["matching"].update(points_per_side=8, testing_point_bs=32,
                           compute_dtype="float32", iou_thr=0.0,
                           analysis_res=32)
    cfg["bank"] = {"classes": 3, "shots": 2, "ref_size": 70}
    return cfg


# tiny DINOv3 encoders: the preset named, cut by `encoder_overrides`, and
# the topology block a configuration file gives for it
TINY_DINOV3 = {
    "plain": ("dinov3_small", {"img_size": 64, "depth": 4}, 384, 6, 1536,
              False),
    "gated": ("dinov3_huge", {"img_size": 64, "feat_dim": 192, "depth": 4,
                              "num_heads": 3}, 192, 3, 768, True),
}


def dinov3_block(dim, depth, heads, mlp_hidden, gated, act="gelu",
                 img_size=592):
    return {"family": "dinov3", "img_size": img_size, "patch_size": 16,
            "dim": dim, "depth": depth, "heads": heads, "registers": 4,
            "mlp_hidden": mlp_hidden, "gated": gated, "act": act,
            "rope_theta": 100.0, "eps": 1e-5}


def tiny_dinov3_config(kind, act="gelu"):
    """The tiny configuration with its DINOv2 replaced by a tiny DINOv3
    (`kind` "plain" or "gated"), its MLP's activation stated as `act`."""
    preset, overrides, dim, heads, hidden, gated = TINY_DINOV3[kind]
    cfg = tiny_config()
    cfg["name"] = f"tiny_v3{kind}" + ("" if act == "gelu" else "_" + act)
    cfg["program"]["encoder_cfg"] = preset
    cfg["program"]["encoder_overrides"] = dict(overrides)
    cfg["topology"]["dino"] = dinov3_block(dim, overrides["depth"], heads,
                                           hidden, gated, act, img_size=64)
    cfg["bank"]["ref_size"] = 64
    return cfg


def add_cell(dst, cfg):
    """Add the configuration `cfg`, the tiny mix, the cell
    `<cfg name>.single` and its limits to the benchmark copy at `dst` (the
    checkout root), by new files and new manifest entries."""
    bench = os.path.join(dst, "portbench")
    name = cfg["name"]
    with open(os.path.join(bench, "configs", name + ".json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "limits", name + ".json"), "w") as f:
        json.dump({"limits": TINY_LIMITS}, f)
    shutil.copy(os.path.join(bench, "counts", "sam2l_dinov2l.py"),
                os.path.join(bench, "counts", name + ".py"))
    mix = os.path.join(bench, "traffic", "tiny_single.json")
    if not os.path.exists(mix):
        with open(os.path.join(bench, "traffic", "single.json")) as f:
            t = json.load(f)
        t.update(long_side=64, short_side=[40, 64], warmup=2,
                 trace_requests=2, check_requests=2, pool=4)
        with open(mix, "w") as f:
            json.dump(t, f)
    path = os.path.join(dst, "BENCHMARK.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["configs"].append({
        "name": name, "source": "test",
        "file": f"portbench/configs/{name}.json", "reduced": [],
        "why": "CPU tests"})
    manifest["workloads"].append(
        {"name": name + ".single", "config": name, "traffic": "tiny_single",
         "chips": 1, "why": "CPU tests"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if any(w.endswith(".single") for w in m.get("workloads", [])):
            m["workloads"].append(name + ".single")
    with open(path, "w") as f:
        json.dump(manifest, f)


def add_tiny(dst):
    """Add the tiny configuration, mix, cell and limits to the
    benchmark copy at `dst` (the checkout root), by new files and new
    manifest entries."""
    add_cell(dst, tiny_config())


def copy_bench(dst):
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A checkout root holding a copy of the benchmark with the tiny
    cells added: `tiny.single`, `tiny_v3plain.single`,
    `tiny_v3gated.single`, and `tiny_v3gated_silu.single`, whose file
    states SiLU for the gate that the program computes with GELU."""
    dst = str(tmp_path_factory.mktemp("tiny_bench"))
    copy_bench(dst)
    add_tiny(dst)
    for kind in TINY_DINOV3:
        add_cell(dst, tiny_dinov3_config(kind))
    add_cell(dst, tiny_dinov3_config("gated", act="silu"))
    return dst


@pytest.fixture(scope="session")
def torch_threads():
    import torch
    torch.set_num_threads(4)


def run_tiny(root, workload, seed=5, seconds=0.5, trace=0):
    """One run of a tiny cell on the CPU with the benchmark code of this
    checkout and the manifest, configurations and mixes of `root`."""
    from portbench import run
    return run.main(["--workload", workload, "--seed", str(seed),
                     "--seconds", str(seconds), "--trace", str(trace)],
                    root=root, bench=os.path.join(root, "portbench"),
                    device="cpu")
