"""Build and load the port's CUDA kernels.

The sources in `no_time_to_train_tpu_torch/csrc/*.cu` are compiled at first
use with `nvcc` into one shared library with a plain C interface, bound with
`ctypes`. The library is written to `build/kernels/` at the repository root
(listed in .gitignore) under a name that carries a hash of the sources, so an
edited source never loads a stale build. Nothing here runs at import time.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["lib", "build_seconds", "check", "dtype_code", "require",
           "stream_ptr"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_LOCK = threading.Lock()
_STATE = {"lib": None, "build_s": None}

_VP, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "nttt_layer_norm": [_VP, _VP, _VP, _VP, _I, _I, _F, _I, _VP],
    "nttt_t2i_attn": [_VP, _VP, _VP, _VP, _VP, _VP, _VP,
                      _I, _I, _I, _I, _F, _I, _LL, _I, _VP],
    "nttt_i2t_norm": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                      _I, _I, _I, _I, _F, _F, _I, _LL, _I, _VP],
    "nttt_upscale_product": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                             _I, _I, _I, _F, _I, _VP],
}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


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
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(tmp)] + [str(s) for s in sources]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
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


def dtype_code(dtype):
    if dtype == torch.bfloat16:
        return 1
    if dtype == torch.float32:
        return 0
    raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")


def stream_ptr(device):
    return torch.cuda.current_stream(device).cuda_stream


def require(cond, msg):
    if not cond:
        raise ValueError(msg)
