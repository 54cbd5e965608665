"""The port's import boundary, and its own copy of the native bindings.

The port (`no_time_to_train_tpu_torch/`, `chip_smoke.py`) imports torch and
nothing of the JAX package, not even a module there that does not import
JAX; only the tests import both. Nor does it import the packages the
machine with the GPU lacks (PyYAML, cv2, matplotlib, safetensors,
transformers, pycocotools), or PIL anywhere but inside the JPEG branch of
`data/image_io.py`.
"""
import ast
import pathlib
import re
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from no_time_to_train_tpu_torch.models.matching import pipeline
from no_time_to_train_tpu_torch.utils import native

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "no_time_to_train_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_names_neither_jax_nor_the_jax_package(path):
    """No port file names `jax` (any import of it would) or a module of the
    JAX package (`no_time_to_train_tpu.` with a dot; a path like
    no_time_to_train_tpu/ops/x.py in a docstring is a reference, not an
    import)."""
    text = path.read_text()
    assert not re.search(r"jax", text), path
    assert "no_time_to_train_tpu." not in text, path


FORBIDDEN = ("yaml", "cv2", "matplotlib", "safetensors", "transformers",
             "pycocotools")
# the one place PIL may be imported: inside a function of this file
PIL_HOME = ROOT / "no_time_to_train_tpu_torch" / "data" / "image_io.py"


def _imports(tree):
    """(top-level module name, inside a function) of every import."""
    out = []

    def visit(node, in_function):
        for child in ast.iter_child_nodes(node):
            inner = in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if isinstance(child, ast.Import):
                out.extend((a.name.split(".")[0], inner) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module \
                    and not child.level:
                out.append((child.module.split(".")[0], inner))
            visit(child, inner)

    visit(tree, False)
    return out


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_package_the_gpu_machine_lacks(path):
    found = _imports(ast.parse(path.read_text()))
    assert not [m for m, _ in found if m in FORBIDDEN], path
    pil = [inner for m, inner in found if m == "PIL"]
    if path == PIL_HOME:
        assert pil and all(pil), "PIL is imported inside the JPEG branch only"
    else:
        assert not pil, path


_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import no_time_to_train_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "no_time_to_train_tpu", "yaml", "PIL",
                                    "cv2", "matplotlib", "safetensors",
                                    "transformers", "pycocotools"))
assert not bad, bad
print(len(mods))
"""


def test_importing_every_port_module_loads_no_jax():
    """A fresh interpreter that imports every module of the port and
    chip_smoke.py ends with neither jax nor the JAX package loaded, nor any
    of the packages the GPU machine lacks."""
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 30


def _blob_outputs():
    """Two smooth blobs and a noise field as winning low-res logits."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    lr = np.zeros((4, 32, 32), np.float16)
    lr[0] = 4.0 - 0.02 * ((yy - 14) ** 2 + (xx - 18) ** 2)
    lr[1] = 3.0 - 0.05 * ((yy - 20) ** 2 + (xx - 9) ** 2)
    lr[2] = rng.standard_normal((32, 32)) * 2
    return dict(lr_logits=lr, valid=np.array([1, 1, 1, 0], bool),
                scores=np.array([0.9, 0.8, 0.7, 0.0], np.float32),
                labels=np.array([3, 1, 2, 0]),
                pred_ious=np.ones(4, np.float32))


def test_native_finalize_matches_the_numpy_path():
    """`finalize_records` (the native one-pass upsample, binarize, RLE and
    box) against `finalize_results(exact_resize=True)` (numpy, torch-parity
    bilinear weights). The two upsample with the same weights in another
    order of float32 operations, so a pixel whose logit is within rounding
    of zero may flip: at least 99.9 % of the pixels agree, and the blobs'
    boxes to one pixel. Without a toolchain the native entry points return
    None and callers take the numpy path."""
    out = _blob_outputs()
    h, w = 150, 203
    ref = pipeline.finalize_results(out, h, w, exact_resize=True)
    rec = pipeline.finalize_records(out, h, w)
    if not native.available():
        assert rec is None and native.rle_encode(np.zeros((2, 2))) is None
        return
    assert native.has_finalize() and rec is not None
    assert len(rec["segs"]) == 3
    np.testing.assert_array_equal(rec["labels"], ref["labels"])
    np.testing.assert_array_equal(rec["scores"], ref["scores"])
    for i, seg in enumerate(rec["segs"]):
        assert seg["size"] == [h, w]
        mask = native.rle_decode(seg["counts"], h, w).astype(bool)
        assert (mask == ref["binary_masks"][i]).mean() > 0.999
        assert native.rle_encode(mask) == seg["counts"]
    np.testing.assert_allclose(rec["bboxes"][:2], ref["bboxes"][:2], atol=1.0)
    up = native.upsample_binarize(out["lr_logits"][:3].astype(np.float32),
                                  h, w)
    assert (up == ref["binary_masks"]).mean() > 0.999
    # the image smaller than the logits: the native path declines
    assert pipeline.finalize_records(out, 16, 20) is None


def test_finalize_mask_from_threads_equals_serial():
    """The finalize buffer is per thread (ROADMAP C.3): 4 threads at once on
    distinct inputs and output sizes give the serial results."""
    assert native.has_finalize()
    rng = np.random.default_rng(3)
    jobs = [(rng.standard_normal((32, 32)).astype(np.float32) * 3,
             40 + 7 * i, 33 + 5 * (i % 9)) for i in range(48)]
    serial = [native.finalize_mask(*job) for job in jobs]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = threading.Barrier(4)

        def run(part):
            start.wait(timeout=60)
            return [native.finalize_mask(*jobs[i]) for i in part]

        with ThreadPoolExecutor(max_workers=4) as pool:
            futs = [pool.submit(run, range(k, len(jobs), 4))
                    for k in range(4)]
            parts = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(interval)
    for k, part in enumerate(parts):
        for i, got in zip(range(k, len(jobs), 4), part):
            want = serial[i]
            assert got[0] == want[0] and got[2] == want[2], i
            np.testing.assert_array_equal(got[1], want[1])
