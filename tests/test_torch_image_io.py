"""The port's image IO (`no_time_to_train_tpu_torch/data/image_io.py`)
against PIL: the PNG reader on every colour type, odd widths and every row
filter; `resize_like_pil` against `Image.resize` bit for bit; `load_image`
on a JPEG against the JAX package's."""
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from no_time_to_train_tpu.data import datasets as j_ds
from no_time_to_train_tpu_torch.data import datasets as t_ds
from no_time_to_train_tpu_torch.data import image_io

# PNG colour type -> (channels, PIL mode)
COLOR_TYPES = {0: (1, "L"), 2: (3, "RGB"), 3: (1, "P"), 4: (2, "LA"),
               6: (4, "RGBA")}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_row(row, prior, ftype, bpp):
    """The PNG encoder's side of one row filter (ints in, bytes out)."""
    out = []
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][ftype]
        out.append((x - pred) % 256)
    return bytes([ftype] + out)


def _write_png(path, px, ctype, palette=None, depth=8, interlace=0,
               filters=(0, 1, 2, 3, 4)):
    """px: uint8 [H, W, C]; row r takes filter filters[r % len]."""
    h, w, c = px.shape
    rows = px.reshape(h, w * c).astype(int).tolist()
    prior = [0] * (w * c)
    data = b""
    for r, row in enumerate(rows):
        data += _filter_row(row, prior, filters[r % len(filters)], c)
        prior = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                      interlace))
    if palette is not None:
        body += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    body += chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(image_io.PNG_SIGNATURE + body)


@pytest.mark.parametrize("ctype", sorted(COLOR_TYPES))
@pytest.mark.parametrize("hw", [(9, 13), (6, 1), (17, 31)])
def test_png_reader_equals_pil_on_every_filter(tmp_path, ctype, hw):
    c, mode = COLOR_TYPES[ctype]
    rng = np.random.default_rng(ctype * 100 + hw[1])
    h, w = hw
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (23, 3))
        px = rng.integers(0, 23, (h, w, 1), dtype=np.uint8)
    else:
        px = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
        px[::3] = px[::3] // 7 * 7             # runs that the filters meet
    path = tmp_path / "f.png"
    _write_png(path, px, ctype, palette)
    with Image.open(path) as im:
        assert im.mode == mode
        np.testing.assert_array_equal(image_io.read_rgb(path),
                                      np.asarray(im.convert("RGB")))
        got, got_type, _ = image_io.read_png(path)
        assert got_type == ctype
        np.testing.assert_array_equal(got[..., 0] if c == 1 else got,
                                      np.asarray(im))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_reader_equals_pil_on_files_pil_wrote(tmp_path, mode):
    """PIL's encoder picks a filter per row by itself."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:61, 0:77]
    smooth = ((yy * 3 + xx * 5) % 256).astype(np.uint8)
    arr = np.stack([smooth, smooth[::-1], rng.integers(0, 256, smooth.shape,
                                                       dtype=np.uint8),
                    smooth // 2], -1)
    im = Image.fromarray(arr, "RGBA")
    im = im.convert("RGB").quantize(64) if mode == "P" else im.convert(mode)
    path = tmp_path / f"{mode}.png"
    im.save(path)
    with Image.open(path) as ref:
        np.testing.assert_array_equal(image_io.read_rgb(path),
                                      np.asarray(ref.convert("RGB")))


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    px = np.zeros((4, 5, 3), np.uint8)
    cases = {"interlaced": dict(interlace=1), "16-bit": dict(depth=16)}
    for what, kw in cases.items():
        path = tmp_path / f"{what}.png"
        _write_png(path, px, 2, **kw)
        with pytest.raises(ValueError, match=what.split("-")[0]):
            image_io.read_png(path)
    path = tmp_path / "crc.png"
    _write_png(path, px, 2)
    raw = bytearray(path.read_bytes())
    raw[-20] ^= 0xFF                      # inside the IDAT chunk
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        image_io.read_png(path)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_save_png_reads_back_in_pil(tmp_path, c):
    px = np.random.default_rng(c).integers(0, 256, (11, 7, c), dtype=np.uint8)
    path = tmp_path / "w.png"
    image_io.save_png(path, px)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im).reshape(px.shape), px)
    np.testing.assert_array_equal(image_io.read_png(path)[0], px)


@pytest.mark.parametrize("wh,out", [
    ((640, 480), 1024), ((333, 500), 1024), ((1500, 1200), 1024),
    ((64, 48), 518), ((97, 61), (40, 150)), ((5, 3), (2, 9))])
def test_resize_like_pil_equals_pil(wh, out):
    w, h = wh
    oh, ow = (out, out) if isinstance(out, int) else out
    rng = np.random.default_rng(w + h)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[: h // 2] = img[: h // 2] // 16 * 16           # edges and flats
    got = image_io.resize_like_pil(img, (oh, ow))
    want = np.asarray(Image.fromarray(img).resize((ow, oh)))
    np.testing.assert_array_equal(got, want)


def test_load_image_on_jpeg_equals_jax(tmp_path):
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:203, 0:311]
    img = np.stack([(xx + yy) % 256, (2 * xx) % 256, rng.integers(
        0, 256, xx.shape)], -1).astype(np.uint8)
    path = str(tmp_path / "img.jpg")
    Image.fromarray(img).save(path, quality=90)
    for size in (None, 1024, (120, 90)):
        for norm in (False, True):
            got = t_ds.load_image(path, size, normalize=norm)
            want = j_ds.load_image(path, size, normalize=norm)
            assert got[1:] == want[1:] == (203, 311)
            assert got[0].dtype == want[0].dtype
            np.testing.assert_array_equal(got[0], want[0])


def test_jpeg_without_pil_names_pil(tmp_path, monkeypatch):
    path = tmp_path / "img.jpg"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        image_io.read_rgb(path)
