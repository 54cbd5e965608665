"""The port's own copy of `no_time_to_train_tpu/data/rle.py`, so that the
port imports nothing of the JAX package.

COCO run-length encoding, self-contained (replaces pycocotools.mask which
is not vendored here; reference uses it at coco_ref_dataset.py:602,652-662).

Formats match the COCO mask API:
  - runs are column-major (Fortran order), alternating background/foreground,
    starting with background;
  - the compressed string uses 6-bit chunks ('0'+code), 0x20 continuation,
    with counts[i>=2] delta-encoded against counts[i-2].

A C++ fast path (native/libnttt) is used when available; the numpy fallback
is exact.
"""
import numpy as np

__all__ = ["encode_mask", "decode_rle", "mask_from_counts", "counts_from_mask",
           "rle_to_string", "string_to_counts", "area", "iou_rle", "merge_hw"]


def counts_from_mask(mask):
    """mask [H, W] (bool/uint8) -> list of run lengths in F-order."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    n = flat.size
    if n == 0:
        return [0]
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [n]])).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    return runs


def mask_from_counts(counts, h, w):
    total = h * w
    flat = np.zeros(total, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        c = int(c)
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T  # F-order


def rle_to_string(counts):
    """COCO LEB-ish compression (maskApi rleToString)."""
    s = []
    cnts = list(map(int, counts))
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return "".join(s)


def string_to_counts(s):
    if isinstance(s, bytes):
        s = s.decode("utf-8")
    cnts = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def encode_mask(mask):
    """[H, W] binary mask -> {'size': [h, w], 'counts': str} (compressed)."""
    h, w = mask.shape
    from no_time_to_train_tpu_torch.utils import native
    s = native.rle_encode(mask) if native.available() else None
    if s is None:
        s = rle_to_string(counts_from_mask(mask))
    return {"size": [int(h), int(w)], "counts": s}


def decode_rle(rle):
    """COCO rle dict (compressed str/bytes counts, or uncompressed list)
    -> [H, W] uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        from no_time_to_train_tpu_torch.utils import native
        if native.available():
            out = native.rle_decode(counts, h, w)
            if out is not None:
                return out
        counts = string_to_counts(counts)
    return mask_from_counts(counts, h, w)


def area(rle):
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    return int(sum(counts[1::2]))


def merge_hw(rles, h, w):
    """Union of several RLE masks -> single mask."""
    out = np.zeros((h, w), np.uint8)
    for r in rles:
        out |= decode_rle(r)
    return out


def _runs_to_arrays(counts):
    c = np.asarray(counts, np.int64)
    ends = np.cumsum(c)
    starts = ends - c
    return starts[1::2], ends[1::2]  # fg run [start, end) intervals


def iou_rle(dt_rles, gt_rles, iscrowd):
    """Pairwise mask IoU matrix [len(dt), len(gt)] with COCO crowd semantics
    (union = det area when the gt is crowd)."""
    if not dt_rles or not gt_rles:
        return np.zeros((len(dt_rles), len(gt_rles)))
    h, w = dt_rles[0]["size"]
    dts = [decode_rle(r).astype(bool) for r in dt_rles]
    gts = [decode_rle(r).astype(bool) for r in gt_rles]
    from no_time_to_train_tpu_torch.utils import native
    if native.available():
        out = native.mask_iou(np.stack(dts), np.stack(gts),
                              np.asarray(iscrowd, np.uint8))
        if out is not None:
            return out
    d = np.stack([m.reshape(-1) for m in dts]).astype(np.float32)
    g = np.stack([m.reshape(-1) for m in gts]).astype(np.float32)
    inter = d @ g.T
    da = d.sum(-1)[:, None]
    ga = g.sum(-1)[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, da, da + ga - inter)
    return np.where(union > 0, inter / union, 0.0)
