"""Build and load the port's CUDA kernels.

The sources in `no_time_to_train_tpu_torch/csrc/*.cu` are compiled at first
use with `nvcc`, one process for each source, all started together, and
linked into one shared library with a plain C interface, bound with
`ctypes`. The library is written to `build/kernels/` at the repository root
(listed in .gitignore) under a name that carries a hash of the sources, so an
edited source never loads a stale build. Nothing here runs at import time.
"""
import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["lib", "build_seconds", "check", "count", "count_replay",
           "dtype_code", "no_grad_operands", "recorded_launches", "require",
           "stream_ptr"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_STATE = {"lib": None, "build_s": None}
# the list of an open `recorded_launches()` (a contextvar: a capture in one
# thread does not take another thread's launches)
_RECORDED = contextvars.ContextVar("nttt_torch_recorded_launches",
                                   default=None)

_VP, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "nttt_layer_norm": [_VP, _VP, _VP, _VP, _I, _I, _F, _I, _VP],
    "nttt_layer_norm_warp": [_VP, _VP, _VP, _VP, _I, _I, _F, _I, _VP],
    "nttt_t2i_attn": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                      _I, _I, _I, _I, _F, _I, _LL, _LL, _I, _I, _I, _VP],
    "nttt_t2i_runs": [_I],
    "nttt_t2i_attn_wmma": [_VP, _VP, _VP, _VP, _VP, _VP, _VP,
                           _I, _I, _I, _I, _F, _I, _LL, _LL, _I, _I, _I,
                           _VP],
    "nttt_i2t_norm": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                      _I, _I, _I, _I, _F, _F, _I, _LL, _LL, _LL, _I, _I, _I,
                      _VP],
    "nttt_i2t_norm_wmma": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                           _VP, _I, _I, _I, _I, _F, _F, _I, _LL, _LL, _LL,
                           _I, _I, _I, _VP],
    "nttt_upscale_product": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                             _I, _I, _I, _I, _I, _F, _I, _VP],
    "nttt_upscale_product_wmma": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                  _VP, _I, _I, _I, _I, _I, _F, _I, _VP],
    "nttt_onepass_attn": [_VP, _VP, _VP, _VP, _LL, _LL, _LL, _I, _I, _I,
                          _I, _I, _I, _I, _I, _F, _I, _I, _VP, _VP, _VP],
    "nttt_onepass_attn_wmma": [_VP, _VP, _VP, _VP, _LL, _LL, _LL, _I, _I, _I,
                               _I, _I, _I, _I, _I, _F, _I, _VP],
    "nttt_window_attn": [_VP, _VP, _I, _I, _I, _I, _I, _F, _I, _VP],
    "nttt_flash_bh": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _I,
                      _I, _VP, _VP, _VP],
    "nttt_flash_bh_wmma": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F,
                           _I, _VP],
    "nttt_window_attn_wmma": [_VP, _VP, _I, _I, _I, _I, _I, _F, _I, _VP],
    "nttt_flash_masked": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                          _I, _F, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP],
    "nttt_flash_masked_wmma": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                               _I, _F, _I, _VP],
    "nttt_masked_tile_list": [_VP, _VP, _VP, _VP, _I, _I, _VP],
    "nttt_quant_rows": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    "nttt_quant_rows_warp": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "nttt_quant_div_check": [_VP, _VP],
    "nttt_int8_gemm": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                       _I, _I, _VP, _VP],
    "nttt_int8_gemm_mma": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                           _VP],
    "nttt_int8_linear": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP, _VP,
                         _VP, _VP, _I, _I, _I, _I, _I, _I, _VP, _VP],
}
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC"]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _finish(cmd, stdout, stderr, returncode):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n"
                           f"{' '.join(cmd)}\n{stdout}\n{stderr}")


def _build():
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha1()
    for p in sorted(_CSRC.iterdir()):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out = _BUILD_DIR / f"libnttt_kernels_{digest.hexdigest()[:12]}.so"
    t0 = time.perf_counter()
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp_dir = _BUILD_DIR / f"obj.{os.getpid()}"
        tmp_dir.mkdir(exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for src in sources:
            cmd = [nvcc, *_ARCH, "-c", "-o", str(tmp_dir / f"{src.stem}.o"),
                   str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        # wait for every compile before reporting one that failed
        done = [(cmd, *proc.communicate(), proc.returncode)
                for cmd, proc in jobs]
        for result in done:
            _finish(*result)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp)] + [
            str(tmp_dir / f"{src.stem}.o") for src in sources]
        res = subprocess.run(cmd, capture_output=True, text=True)
        _finish(cmd, res.stdout, res.stderr, res.returncode)
        os.replace(tmp, out)
        shutil.rmtree(tmp_dir, ignore_errors=True)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, time.perf_counter() - t0


def lib():
    """The loaded kernel library, built on first call."""
    with _LOCK:
        if _STATE["lib"] is None:
            _STATE["lib"], _STATE["build_s"] = _build()
        return _STATE["lib"]


def build_seconds():
    """Seconds the first `lib()` call spent compiling and loading."""
    return _STATE["build_s"]


def check(err, name):
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def count(launches, name):
    """Add one launch of `name` to a wrapper's counter dict. Replicas of a
    model launch from several threads at once (`parallel/mesh.py`), so the
    add holds a lock. Inside `recorded_launches()` the launch is listed
    instead of counted."""
    rec = _RECORDED.get()
    if rec is not None:
        rec.append((launches, name))
        return
    with _COUNT_LOCK:
        launches[name] += 1


@contextlib.contextmanager
def recorded_launches():
    """Yield the list of the launches made inside, which are not counted: a
    CUDA graph's capture runs no kernel; `count_replay` counts them at each
    replay."""
    rec = []
    tok = _RECORDED.set(rec)
    try:
        yield rec
    finally:
        _RECORDED.reset(tok)


def count_replay(recorded):
    """Count the launches of `recorded_launches()` once more."""
    with _COUNT_LOCK:
        for launches, name in recorded:
            launches[name] += 1


def dtype_code(dtype):
    if dtype == torch.bfloat16:
        return 1
    if dtype == torch.float32:
        return 0
    raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")


def stream_ptr(device):
    """The current CUDA stream of `device` as a pointer (the raw accessor:
    no Stream object is made, a few microseconds a launch)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def no_grad_operands(name, *operands):
    """Raise where autograd would record a kernel call: no kernel of the
    port has a backward (the JAX package's Pallas kernels have no autodiff
    rule either), so a differentiated computation must run its plain
    versions inside `no_fusion()`. Entries call this before they launch;
    `operands` may hold None and non-tensors."""
    if not torch.is_grad_enabled():
        return
    for x in operands:
        if isinstance(x, torch.Tensor) and x.requires_grad:
            raise RuntimeError(
                f"{name}: a kernel has no backward and an operand requires "
                "grad; run the differentiated code inside no_fusion() or "
                "under torch.no_grad()")


def require(cond, msg):
    if not cond:
        raise ValueError(msg)
