"""The port's PNG decoder (``data/dataset.py::png_decode`` over the native
unfilter ``runtime/native/png.cpp``) held to what the JAX package reads with
``imageio.v3.imread``: bit-equal on Pillow-written files (gray, RGB, RGBA,
palettes at 8, 4 and 1 bits with and without ``tRNS``, 16-bit gray) and on
files written here with one filter type forced on every row (8-bit gray,
RGB and RGBA, 16-bit gray and RGB, which Pillow cannot write). The native
unfilter is bit-equal to the plain loop on random rows of every filter and
bytes-per-pixel.

Two read results differ by design and are held here: a palette with
``tRNS`` decodes to RGBA in the port, where imageio drops the alpha (the
RGB channels are equal, and ``imread``, which keeps three channels, is
bit-equal to the reference's); 16-bit colour images give their high bytes,
as Pillow reads them.
"""
import io
import logging
import struct
import zlib

import numpy as np
import pytest

from mav_detection_tpu.data import dataset as jdataset

from mav_detection_tpu_torch import _build
from mav_detection_tpu_torch.data import dataset as tdataset
from mav_detection_tpu_torch.data.scene import bench_scene


@pytest.fixture
def rng():
    """A generator of this test's own (the repository-wide ``rng`` fixture is
    one stream shared with the JAX package's tests)."""
    return np.random.default_rng(6)


def _textured(h=40, w=56, c=3, seed=0):
    """A smooth bench-scene texture: Pillow picks Paeth for most rows of it."""
    gray = np.clip(bench_scene(seed, h, w)[0], 0, 255).astype(np.uint8)
    planes = [gray, gray[::-1], gray[:, ::-1], 255 - gray][:c]
    return np.stack(planes, -1) if c > 1 else gray


def _pillow_png(img, **save_kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(
        buf, format="png", **save_kw)
    return buf.getvalue()


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def filter_rows(rows: np.ndarray, bpp: int, ftypes) -> np.ndarray:
    """PNG-filter (h, stride) bytes with filter ``ftypes[y]`` on row y; every
    predictor reads unfiltered bytes, so each filter is one array
    expression. Returns (h, 1 + stride) with the filter byte first."""
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, paeth]
    ftypes = np.broadcast_to(np.asarray(ftypes), (x.shape[0],))
    out = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    out[:, 0] = ftypes
    for y, f in enumerate(ftypes):
        out[y, 1:] = (x[y] - preds[f][y]) & 0xFF
    return out


def encode_png(img: np.ndarray, ftypes, depth: int = 8) -> bytes:
    """A PNG of gray / gray+alpha / RGB / RGBA ``img`` at ``depth`` bits
    (uint8 or uint16 samples), with the given filter on each row."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    samples = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    rows = samples.view(np.uint8).reshape(h, -1)
    filtered = filter_rows(rows, c * depth // 8, ftypes)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes()))
            + _chunk(b"IEND", b""))


def _row_filters(data: bytes) -> set:
    """The filter types a PNG's rows carry (8-bit, non-interlaced)."""
    ihdr = data.index(b"IHDR")
    h = struct.unpack(">I", data[ihdr + 8:ihdr + 12])[0]
    idat = b"".join(data[i + 4:i + 4 + struct.unpack(">I", data[i - 4:i])[0]]
                    for i in range(len(data)) if data[i:i + 4] == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


def _imageio():
    return pytest.importorskip("imageio.v3")


PILLOW_CASES = {
    "gray": lambda: _textured(c=1),
    "rgb": lambda: _textured(c=3),
    "rgba": lambda: _textured(c=4),
    "gray16": lambda: (_textured(c=1).astype(np.uint16) * 257 + 3),
}


@pytest.mark.parametrize("case", sorted(PILLOW_CASES))
def test_pillow_files_bit_equal_to_imageio(case):
    """Pillow-written gray, RGB, RGBA and 16-bit gray: the port's decode is
    imageio's read, bit for bit, and ``imread`` is the reference's."""
    iio = _imageio()
    pytest.importorskip("PIL")
    img = PILLOW_CASES[case]()
    data = _pillow_png(img)
    if case != "gray16":
        assert 4 in _row_filters(data)      # Paeth rows present
    got = tdataset.png_decode(data)
    ref = iio.imread(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("colors", [256, 16, 2], ids=["8bit", "4bit", "1bit"])
@pytest.mark.parametrize("trns", [False, True], ids=["plain", "trns"])
def test_pillow_palettes(colors, trns, tmp_path):
    """Palette files as Pillow writes them (bit depth from the colour count):
    RGB equal to imageio's; with ``tRNS`` the port adds the alpha of each
    palette entry; ``imread`` bit-equal to the reference's either way."""
    iio = _imageio()
    from PIL import Image

    pal = Image.fromarray(_textured(c=3)).quantize(colors)
    kw = {"transparency": bytes(range(0, 250, 50))} if trns else {}
    data = _pillow_png(pal, **kw)
    depth = data[data.index(b"IHDR") + 12]
    assert depth == {256: 8, 16: 4, 2: 1}[colors]
    got = tdataset.png_decode(data)
    ref = iio.imread(data)
    assert got.dtype == np.uint8 and ref.shape == got.shape[:2] + (3,)
    np.testing.assert_array_equal(got[..., :3], ref)
    if trns:
        index = np.asarray(pal)
        alpha = np.full(256, 255, np.uint8)
        alpha[:5] = np.arange(0, 250, 50)
        np.testing.assert_array_equal(got[..., 3], alpha[index])
    else:
        assert got.shape[2] == 3
    path = str(tmp_path / "p.png")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(tdataset.imread(path), jdataset.imread(path))


ENCODED_CASES = [
    ("gray", 1, 8), ("rgb", 3, 8), ("rgba", 4, 8), ("gray+alpha", 2, 8),
    ("gray16", 1, 16), ("rgb16", 3, 16)]


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("name,channels,depth", ENCODED_CASES,
                         ids=[c[0] for c in ENCODED_CASES])
def test_forced_filters_bit_equal_to_imageio(name, channels, depth, ftype, rng):
    """One filter type on every row, each colour type at 8 and 16 bits: the
    port's decode equals imageio's read (16-bit colour: the high bytes, as
    Pillow gives them)."""
    iio = _imageio()
    hi = 65536 if depth == 16 else 256
    shape = (9, 11) if channels == 1 else (9, 11, channels)
    img = rng.integers(0, hi, shape).astype(np.uint16 if depth == 16 else np.uint8)
    data = encode_png(img, ftype, depth)
    got = tdataset.png_decode(data)
    ref = iio.imread(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    expect = img if (depth == 8 or channels == 1) else (img >> 8).astype(np.uint8)
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("bpp", range(1, 9))
def test_native_unfilter_equals_the_plain_loop(bpp, rng):
    """Random filtered rows (every filter type mixed, random bytes): the
    native unfilter and ``unfilter_plain`` give the same bytes."""
    h, stride = 23, bpp * 13
    raw = rng.integers(0, 256, (h, 1 + stride)).astype(np.uint8)
    raw[:, 0] = rng.permutation(np.resize(np.arange(5), h))
    native = tdataset.png_unfilter(raw, bpp)
    assert tdataset._native_unfilter()
    np.testing.assert_array_equal(native, tdataset.unfilter_plain(raw, bpp))


def test_native_decode_is_counted():
    data = encode_png(_textured(120, 160, 3), 4)
    before = dict(tdataset.DECODES)
    tdataset.png_decode(data)
    assert tdataset.DECODES["native"] == before["native"] + 1
    assert tdataset.DECODES["plain"] == before["plain"]


def test_bad_filter_type_raises_on_both_paths(rng):
    raw = rng.integers(0, 256, (4, 9)).astype(np.uint8)
    raw[:, 0] = [0, 1, 7, 2]
    with pytest.raises(ValueError, match="row 2"):
        tdataset.png_unfilter(raw, 1)
    with pytest.raises(ValueError, match="row 2"):
        tdataset.unfilter_plain(raw, 1)


@pytest.mark.parametrize("depth,colour,interlace", [
    (4, 0, 0), (2, 0, 0), (1, 0, 0), (8, 2, 1)])
def test_sub_byte_gray_and_interlaced_raise_naming_them(depth, colour, interlace):
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, depth, colour, 0, 0,
                                          interlace))
            + _chunk(b"IDAT", zlib.compress(bytes(64))) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=f"bit depth {depth}.*interlace {interlace}"):
        tdataset.png_decode(data)


def test_without_gxx_the_loop_runs_and_says_so_once(monkeypatch, caplog, tmp_path):
    """No g++: the Python loop decodes, with one WARNING for the process."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_target", lambda src: tmp_path / "none.so")
    monkeypatch.setattr(tdataset, "_UNFILTER", None)
    monkeypatch.setattr(tdataset, "DECODES", {"native": 0, "plain": 0})
    data = encode_png(_textured(12, 16, 3), 4)
    with caplog.at_level(logging.WARNING, logger="mav_detection_tpu_torch.data"):
        a = tdataset.png_decode(data)
        b = tdataset.png_decode(data)
    assert caplog.text.count("Python loop") == 1
    assert tdataset.DECODES == {"native": 0, "plain": 2}
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, _textured(12, 16, 3))


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that is present but fails: the decode raises."""
    bad = tmp_path / "png.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setitem(_build.SOURCES, "png", _build.SOURCES["png"]._replace(
        path=bad, out_dir=tmp_path / "lib"))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(tdataset, "_UNFILTER", None)
    with pytest.raises(RuntimeError, match="build failed"):
        tdataset.png_decode(encode_png(_textured(8, 8, 1), 1))


def test_port_imwrite_is_read_back_by_imageio(tmp_path):
    iio = _imageio()
    img = _textured(c=3)
    path = str(tmp_path / "x.png")
    tdataset.imwrite(path, img)
    np.testing.assert_array_equal(iio.imread(path)[..., ::-1], img)
    np.testing.assert_array_equal(tdataset.imread(path), img)
