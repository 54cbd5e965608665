"""ctypes bindings for the native host runtime (native/libnttt.so at the
repository root), the port's own copy of
`no_time_to_train_tpu/utils/native.py` so that the port imports nothing of
the JAX package.

The library is built with `make` on first use when a toolchain is there.
Every entry point returns None when the library is missing, and its callers
then take a numpy path: RLE encode / decode, mask IoU, and the
per-image mask finalize upsample.
"""
import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB = None
_TRIED = False
_LOAD_LOCK = threading.Lock()

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")


def _load():
    with _LOAD_LOCK:            # first use may come from several threads
        return _load_locked()


def _load_locked():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_NATIVE_DIR, "libnttt.so")
    src = os.path.join(_NATIVE_DIR, "nttt_native.cpp")
    stale = (os.path.exists(src) and
             (not os.path.exists(so)
              or os.path.getmtime(src) > os.path.getmtime(so)))
    if stale:
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            if not os.path.exists(so):
                return None
    if not os.path.exists(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.rle_encode.restype = ctypes.c_int64
    lib.rle_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_char_p]
    lib.rle_decode.restype = ctypes.c_int32
    lib.rle_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_void_p]
    lib.rle_area_from_counts.restype = ctypes.c_int64
    lib.rle_area_from_counts.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.mask_iou.restype = None
    lib.mask_iou.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                             ctypes.c_void_p, ctypes.c_int64,
                             ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.upsample_binarize.restype = None
    lib.upsample_binarize.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_float, ctypes.c_void_p]
    if hasattr(lib, "finalize_mask"):  # an older cached .so may predate it
        lib.finalize_mask.restype = ctypes.c_int64
        lib.finalize_mask.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_float,
                                      ctypes.c_char_p, ctypes.c_void_p,
                                      ctypes.c_void_p]
    _LIB = lib
    return lib


def available():
    return _load() is not None


def rle_encode(mask):
    lib = _load()
    if lib is None:
        return None
    m = np.ascontiguousarray(mask, np.uint8)
    h, w = m.shape
    buf = ctypes.create_string_buffer(8 * h * w + 16)
    n = lib.rle_encode(m.ctypes.data, h, w, buf)
    return buf.raw[:n].decode("ascii")


def rle_decode(counts_str, h, w):
    lib = _load()
    if lib is None:
        return None
    s = counts_str.encode("ascii") if isinstance(counts_str, str) \
        else counts_str
    out = np.empty((h, w), np.uint8)
    rc = lib.rle_decode(s, len(s), h, w, out.ctypes.data)
    return out if rc == 0 else None


def mask_iou(dt_masks, gt_masks, iscrowd):
    lib = _load()
    if lib is None:
        return None
    dt = np.ascontiguousarray(dt_masks, np.uint8)
    gt = np.ascontiguousarray(gt_masks, np.uint8)
    nd, h, w = dt.shape
    ng = gt.shape[0]
    ic = np.ascontiguousarray(iscrowd, np.uint8)
    out = np.empty((nd, ng), np.float64)
    lib.mask_iou(dt.ctypes.data, nd, gt.ctypes.data, ng, ic.ctypes.data,
                 h * w, out.ctypes.data)
    return out


# finalize_mask's output buffer, one per thread: the runner finalizes on
# its own thread while a loader thread runs
_TLS = threading.local()


def has_finalize():
    lib = _load()
    return lib is not None and hasattr(lib, "finalize_mask")


def finalize_mask(logits, out_h, out_w, threshold=0.0):
    """Fused per-mask finalize: bilinear upsample [in_h, in_w] f32 logits to
    (out_h, out_w), binarize, and return the COCO RLE counts string plus the
    XYXY box and pixel count — without materializing the full-res mask
    (one native column-major pass, see native/nttt_native.cpp). Returns
    (counts_str, box float32[4], n_pixels) or None when the lib is absent."""
    lib = _load()
    if lib is None or not hasattr(lib, "finalize_mask"):
        return None
    x = np.ascontiguousarray(logits, np.float32)
    in_h, in_w = x.shape
    need = 8 * out_h * out_w + 16
    buf = getattr(_TLS, "buf", None)
    if buf is None or len(buf) < need:
        buf = _TLS.buf = ctypes.create_string_buffer(need)
    box = np.zeros(4, np.int32)
    npix = ctypes.c_int64(0)
    n = lib.finalize_mask(x.ctypes.data, in_h, in_w, out_h, out_w,
                          ctypes.c_float(threshold), buf,
                          box.ctypes.data, ctypes.byref(npix))
    return (buf.raw[:n].decode("ascii"), box.astype(np.float32),
            int(npix.value))


def upsample_binarize(logits, out_h, out_w, threshold=0.0):
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(logits, np.float32)
    n, in_h, in_w = x.shape
    out = np.empty((n, out_h, out_w), np.uint8)
    lib.upsample_binarize(x.ctypes.data, n, in_h, in_w, out_h, out_w,
                          ctypes.c_float(threshold), out.ctypes.data)
    return out.astype(bool)
