"""A cell, a configuration, a traffic mix and a per-layer metric are added
by adding files and manifest entries, and the harness finds them by name:
no file that the benchmark already has changes."""
import hashlib
import json
import os

import pytest

from conftest import (ROOT, TINY_DINOV3, add_cell, add_tiny, copy_bench,
                      run_tiny, tiny_dinov3_config)

NEW_METRIC = '''"""Host seconds of the window, a made-up metric for the test."""
LAYER = "test layer"
UNIT = "ms"
MOVES = "image_ms_p50"
WORKLOADS = ["tiny.single"]


def read(run):
    return run.record.seconds * 1e3
'''


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha1(
                open(p, "rb").read()).hexdigest()
    return out


def test_added_files_are_found(tmp_path, torch_threads):
    root = str(tmp_path)
    copy_bench(root)
    before = _digests(root)
    add_tiny(root)                 # a configuration, a mix, a cell
    with open(os.path.join(root, "portbench", "metrics",
                           "test.window_ms.py"), "w") as f:
        f.write(NEW_METRIC)
    path = os.path.join(root, "BENCHMARK.json")
    manifest = json.load(open(path))
    manifest["per_layer"].append({
        "name": "test.window_ms", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "test layer",
        "moves": "image_ms_p50", "workloads": ["tiny.single"]})
    json.dump(manifest, open(path, "w"))
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) >= {
        "portbench/configs/tiny.json", "portbench/traffic/tiny_single.json",
        "portbench/counts/tiny.py",
        "portbench/limits/tiny.json", "portbench/metrics/test.window_ms.py"}

    res = run_tiny(root, "tiny.single", trace=1)
    assert "test.window_ms" in res["metrics"]
    assert "matcher.enqueue_ms.single" in res["metrics"]
    res = run_tiny(root, "tiny.single", trace=0)
    assert set(res["metrics"]) == {"image_ms_p50", "peak_mem_gib",
                                   "setup_s"}
    assert res["correct"]


@pytest.mark.parametrize("kind", sorted(TINY_DINOV3))
def test_dinov3_cell_is_added_by_files(tmp_path, torch_threads, kind):
    """A configuration that names a DINOv3 encoder (its `topology.dino`
    with `family`, `registers`, `mlp_hidden`, `gated`, `act`, `rope_theta`,
    `eps`) is added by files and manifest entries alone, and its cell runs
    the whole check with `correct` true."""
    root = str(tmp_path)
    copy_bench(root)
    before = _digests(root)
    cfg = tiny_dinov3_config(kind)
    add_cell(root, cfg)
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())
    res = run_tiny(root, cfg["name"] + ".single", seed=25)
    assert res["correct"], res["check"]
    for n in ("dino_cos", "score_gap", "tail_gap"):
        assert res["check"][n]["value"] < 1e-4, n


def test_repo_manifest_is_untouched():
    """The copy the tests build leaves the repository's own files alone."""
    manifest = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert not any(w["name"].startswith("tiny") for w in
                   manifest["workloads"])
