"""Image decoding and resizing for the port's data layer, without PIL on the
main path.

- `read_png`: a PNG reader on `zlib` and numpy for 8-bit gray, gray + alpha,
  RGB, RGBA and palette images, all five row filters; interlaced and 16-bit
  files are refused with a clear error.
- `read_rgb`: any image file as uint8 RGB [H, W, 3], as PIL's
  `Image.open(path).convert("RGB")` gives it. PNG goes through `read_png`;
  every other format (JPEG) through PIL, imported inside the function.
- `read_gray`: any image file as uint8 [H, W], as PIL's
  `Image.open(path).convert("L")` gives it (ITU-R 601-2 luma in PIL's
  16-bit fixed point).
- `resize_like_pil`: PIL's default `Image.resize` filter (bicubic, a = -0.5)
  in numpy, bit for bit: PIL's coefficients in 22-bit fixed point, a
  horizontal pass rounded to uint8, then a vertical one. The data layer
  always resizes with it, with PIL installed or not.
- `resize_linear_cv2` / `resize_nearest_cv2`: what OpenCV's `cv2.resize`
  gives with INTER_LINEAR on float32 and INTER_NEAREST, bit for bit, for the
  scripts that the reference wrote on cv2 (the port has no cv2).
- `save_png`: a plain PNG writer (filter 0), for fabricated data sets and
  the visualizations.
"""
import math
import struct
import zlib

import numpy as np

__all__ = ["read_png", "read_rgb", "read_gray", "resize_like_pil",
           "resize_linear_cv2", "resize_nearest_cv2", "save_png"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels per pixel (0 gray, 2 RGB, 3 palette, 4 gray +
# alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data, path):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends before IEND")


def _unfilter(raw, h, w, bpp):
    """Undo the PNG row filters. raw: [h, 1 + w * bpp] uint8, the filter type
    first in each row. Pixel (r, i) depends on (r, i - 1), (r - 1, i) and
    (r - 1, i - 1), so every pixel of one anti-diagonal r + i = d is undone
    at once, whatever the filter of its row."""
    ftype = raw[:, 0].astype(np.int64)
    if (ftype > 4).any():
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    x = raw[:, 1:].reshape(h, w, bpp).astype(np.int64)
    if (ftype == 0).all():
        return x.astype(np.uint8)
    out = np.zeros((h + 1, w + 1, bpp), np.int64)   # row 0 / column 0: zeros
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        i = d - r
        a = out[r + 1, i]          # left
        b = out[r, i + 1]          # up
        c = out[r, i]              # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftype[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, i + 1] = (x[r, i] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path):
    """-> (pixels uint8 [H, W, C], colour type, palette uint8 [n, 3] or
    None). C is 1 (gray or palette index), 2, 3 or 4."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG samples are not supported "
                         f"(8-bit only)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: PNG image data has {raw.size} bytes, "
                         f"expected {h * (1 + w * bpp)}")
    return _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp), ctype, palette


def _png_rgb(path):
    px, ctype, palette = read_png(path)
    if ctype == 3:
        idx = px[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index past the PLTE entries")
        return palette[idx]
    if ctype in (0, 4):                  # gray (+ alpha, dropped)
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])     # RGB, RGBA (alpha dropped)


def read_rgb(path):
    """Image file -> uint8 [H, W, 3]: PNG by `read_png`, anything else
    (JPEG) by PIL."""
    with open(path, "rb") as f:
        is_png = f.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE
    if is_png:
        return _png_rgb(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading a non-PNG image (JPEG) needs PIL "
                          f"(Pillow), which is not installed") from e
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def read_gray(path):
    """Image file -> uint8 [H, W], as PIL's `Image.open(path).convert("L")`
    gives it: gray PNGs as they are, colour ones through PIL's luma
    (R 19595 + G 38470 + B 7471 + 2^15) >> 16."""
    with open(path, "rb") as f:
        is_png = f.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE
    if is_png:
        px, ctype, _ = read_png(path)
        if ctype in (0, 4):
            return np.ascontiguousarray(px[..., 0])
    rgb = read_rgb(path).astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _bicubic(x):
    """PIL's bicubic_filter, a = -0.5, in its order of operations."""
    x = np.abs(x)
    near = ((-0.5 + 2.0) * x - (-0.5 + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _pil_coeffs(in_size, out_size):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc for the bicubic
    filter: per output index, source indices [out, k] and 22-bit fixed-point
    weights [out, k] (0 past each window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)
    pos = xmin[:, None] + taps
    live = taps < xmax[:, None]
    w = np.where(live, _bicubic(((pos - center[:, None]) + 0.5)
                                * (1.0 / filterscale)), 0.0)
    total = np.zeros(out_size)
    for t in range(ksize):             # PIL sums the taps in order
        total = total + w[:, t]
    w = np.where(total[:, None] != 0.0, w / total[:, None], w)
    fixed = np.where(w < 0, -0.5 + w * (1 << 22), 0.5 + w * (1 << 22))
    return np.minimum(pos, in_size - 1), fixed.astype(np.int64)


def _resample_axis(img, axis, out_size):
    idx, k = _pil_coeffs(img.shape[axis], out_size)
    shape = [1] * img.ndim
    shape[axis] = out_size
    # PIL's int32 sums: |sum| < 255 * 1.3 * 2 ** 22 cannot overflow
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << 21, np.int32)
    k = k.astype(np.int32)
    for t in range(idx.shape[1]):
        acc += (np.take(img, idx[:, t], axis=axis).astype(np.int32)
                * k[:, t].reshape(shape))
    return np.clip(acc >> 22, 0, 255).astype(np.uint8)


def resize_like_pil(img, size):
    """uint8 [H, W, C] -> uint8 [h, w, C], equal bit for bit to PIL's
    `Image.fromarray(img).resize((w, h))` (bicubic). size: (h, w)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_like_pil takes uint8 [H, W, C], got "
                         f"{img.dtype} {img.shape}")
    h, w = size
    if (h, w) == img.shape[:2]:
        return img.copy()
    if w != img.shape[1]:
        img = _resample_axis(img, 1, w)
    if h != img.shape[0]:
        img = _resample_axis(img, 0, h)
    return img


def _linear_taps(n_in, n_out):
    """Two-tap linear weights with half-pixel centres, the position in
    float64, the edges clamped: (left index, right index, right weight as
    float32)."""
    pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    left = np.floor(pos).astype(np.int64)
    frac = pos - left
    frac[left < 0] = 0.0
    left = np.clip(left, 0, n_in - 1)
    frac[left >= n_in - 1] = 0.0
    return left, np.minimum(left + 1, n_in - 1), frac.astype(np.float32)


def _lerp(a, b, t):
    """a + (b - a) t on float32 as a fused multiply-add: the product is
    exact in float64 and the sum is rounded to float64, then to float32
    (twice rounded only where the float64 sum falls on a float32 midpoint,
    which no shape in the tests meets)."""
    d = (b - a).astype(np.float64)
    return (d * t.astype(np.float64) + a).astype(np.float32)


def resize_linear_cv2(x, size):
    """float32 [H, W, ...] -> [h, w, ...], size (h, w): `cv2.resize(x, (w,
    h), interpolation=cv2.INTER_LINEAR)` as OpenCV's wheels compute it for
    float32 (through Intel IPP), bit for bit: half-pixel centres, edges
    clamped, a horizontal pass and then a vertical one, each a + (b - a) t
    with a fused multiply-add."""
    x = np.asarray(x, np.float32)
    h, w = size
    l, r, t = _linear_taps(x.shape[1], w)
    t = t.reshape((1, w) + (1,) * (x.ndim - 2))
    x = _lerp(x[:, l], x[:, r], t)
    l, r, t = _linear_taps(x.shape[0], h)
    return _lerp(x[l], x[r], t.reshape((h,) + (1,) * (x.ndim - 1)))


def resize_nearest_cv2(x, size):
    """[H, W, ...] -> [h, w, ...], size (h, w): `cv2.resize(x, (w, h),
    interpolation=cv2.INTER_NEAREST)`, bit for bit: source index
    floor(i * in / out)."""
    x = np.asarray(x)
    h, w = size

    def index(n_in, n_out):
        return np.minimum(np.floor(np.arange(n_out) * (1.0 / (n_out / n_in))
                                   ).astype(np.int64), n_in - 1)

    return x[index(x.shape[0], h)][:, index(x.shape[1], w)]


def save_png(path, img):
    """uint8 [H, W] or [H, W, C] (C in 1-4) -> an 8-bit PNG, filter 0."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))
