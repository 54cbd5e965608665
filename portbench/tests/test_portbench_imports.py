"""The benchmark's import boundary: nothing under `portbench/` imports
JAX or the JAX package, and the reference imports nothing of the program.
Top-level module names are compared whole: `no_time_to_train_tpu_torch`
begins with the JAX package's name."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")
JAX_SIDE = {"jax", "jaxlib", "flax", "no_time_to_train_tpu"}
PROGRAM = "no_time_to_train_tpu_torch"


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_no_jax_anywhere():
    for path in _sources():
        assert not _imported_tops(path) & JAX_SIDE, path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = _imported_tops(path)
        assert PROGRAM not in tops and not tops & JAX_SIDE, path
        # nor through the benchmark's own program-facing modules
        assert not any(t == "portbench" for t in tops) or all(
            m.startswith("portbench.reference") for m in _from_modules(path)
            if m.startswith("portbench")), path


def _from_modules(path):
    tree = ast.parse(open(path).read(), path)
    return [n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.level == 0]


@pytest.mark.parametrize("module", ["portbench.reference.matcher",
                                    "portbench.reference.models"])
def test_reference_loads_alone(module):
    """Imported in a fresh interpreter, the reference pulls in neither the
    program nor JAX."""
    code = ("import sys; import %s; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % module)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip()))
    assert PROGRAM not in tops and not tops & JAX_SIDE


def test_run_refuses_without_a_card(tmp_path):
    """Without CUDA devices the command exits non-zero and prints no
    result line."""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "sam2l_dinov2l.single", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and `portbench/`, the
    command exits non-zero and prints no result line."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "sam2l_dinov2l.single", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
