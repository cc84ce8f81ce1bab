"""The port's PNG decoder (hiast_tpu_torch/data/png.py) on standard PNGs.

Each file is built here with ``zlib``, its rows under every filter type
(row y under filter y % 5: None, Sub, Up, Average, Paeth), and the decode
is held against the array it encodes and against PIL: 8-bit gray, RGB and
RGBA; 16-bit gray and RGB (read as big-endian uint16); palette images at 1,
2, 4 and 8 bits (looked up in PLTE, or their indices); gray at 1, 2 and 4
bits.  Interlaced files, unknown filter types and truncated data raise
``ValueError`` naming the file.  The native unfilter is held against the
plain one in tests/test_torch_host_ops.py; here, which one a device gets.
"""
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from hiast_tpu_torch.data import png
from hiast_tpu_torch.data.native_ops import host_ops_for, unfilter_native
from hiast_tpu_torch.data.datasets import read_gray, read_rgb

RNG = np.random.default_rng(17)
H, W = 23, 37  # odd sizes: sub-byte rows end in padding bits


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _filter(rows: np.ndarray, bpp: int, kinds) -> bytes:
    """[h, stride] unfiltered bytes -> the filtered stream, row y under kinds[y]."""
    x = rows.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    corner = np.zeros_like(x)
    corner[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - corner
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - corner)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, corner))
    preds = (np.zeros_like(x), left, up, (left + up) >> 1, paeth)
    out = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    for y, k in enumerate(kinds):
        out[y, 0] = k
        out[y, 1:] = (x[y] - preds[k][y]) % 256
    return out.tobytes()


def _pack(values: np.ndarray, depth: int) -> np.ndarray:
    """[h, w] samples of ``depth`` < 8 bits -> [h, ceil(w * depth / 8)] bytes."""
    bits = (values[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(values.shape[0], -1).astype(np.uint8), axis=1)


def _png(rows, w, h, depth, colour, bpp, plte=None, interlace=0, kinds=None) -> bytes:
    kinds = [y % 5 for y in range(h)] if kinds is None else kinds
    blob = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if plte is not None:
        blob += _chunk(b"PLTE", plte.tobytes())
    # two IDAT chunks: a decoder must join them
    data = zlib.compress(_filter(rows, bpp, kinds), 6)
    return blob + _chunk(b"IDAT", data[:17]) + _chunk(b"IDAT", data[17:]) + _chunk(b"IEND", b"")


def _pil(blob, mode=None):
    img = Image.open(io.BytesIO(blob))
    return np.asarray(img.convert(mode) if mode else img)


@pytest.mark.parametrize("channels,colour", [(1, 0), (2, 4), (3, 2), (4, 6)])
def test_8_bit_every_filter(channels, colour):
    arr = RNG.integers(0, 256, size=(H, W, channels)).astype(np.uint8)
    blob = _png(arr.reshape(H, -1), W, H, 8, colour, channels)
    got = png.decode_png(blob)
    want = arr[..., 0] if channels == 1 else arr
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_pil(blob), want)


@pytest.mark.parametrize("channels,colour", [(1, 0), (3, 2), (4, 6)])
def test_16_bit_every_filter(channels, colour):
    arr = RNG.integers(0, 65536, size=(H, W, channels)).astype(np.uint16)
    blob = _png(arr.astype(">u2").view(np.uint8).reshape(H, -1), W, H, 16, colour, 2 * channels)
    got = png.decode_png(blob)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, arr[..., 0] if channels == 1 else arr)
    if channels == 1:  # PIL keeps 16-bit gray as it is
        np.testing.assert_array_equal(_pil(blob).astype(np.uint16), arr[..., 0])
    else:  # and cuts 16-bit colour to its high bytes, as read_rgb does
        np.testing.assert_array_equal(_pil(blob, "RGB"), (arr[..., :3] >> 8).astype(np.uint8))


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette_every_filter(depth, tmp_path):
    n = 1 << depth
    plte = RNG.integers(0, 256, size=(n, 3)).astype(np.uint8)
    idx = RNG.integers(0, n, size=(H, W)).astype(np.uint8)
    rows = idx if depth == 8 else _pack(idx, depth)
    blob = _png(rows, W, H, depth, 3, 1, plte=plte)
    np.testing.assert_array_equal(png.decode_png(blob), plte[idx])
    np.testing.assert_array_equal(png.decode_png(blob, palette=False), idx)
    np.testing.assert_array_equal(_pil(blob, "RGB"), plte[idx])
    np.testing.assert_array_equal(_pil(blob), idx)
    path = tmp_path / "p.png"
    path.write_bytes(blob)
    # a palette label map reads as its indices, an image as its colours (as with PIL)
    np.testing.assert_array_equal(read_gray(str(path)), idx)
    np.testing.assert_array_equal(read_rgb(str(path)), plte[idx])


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_low_bit_gray_every_filter(depth):
    values = RNG.integers(0, 1 << depth, size=(H, W)).astype(np.uint8)
    blob = _png(_pack(values, depth), W, H, depth, 0, 1)
    want = values * (255 // ((1 << depth) - 1))
    np.testing.assert_array_equal(png.decode_png(blob), want)
    np.testing.assert_array_equal(_pil(blob, "L"), want)


def test_16_bit_readers(tmp_path):
    gray = RNG.integers(0, 65536, size=(H, W, 1)).astype(np.uint16)
    rgb = RNG.integers(0, 65536, size=(H, W, 3)).astype(np.uint16)
    (tmp_path / "g.png").write_bytes(_png(gray.astype(">u2").view(np.uint8).reshape(H, -1), W, H, 16, 0, 2))
    (tmp_path / "c.png").write_bytes(_png(rgb.astype(">u2").view(np.uint8).reshape(H, -1), W, H, 16, 2, 6))
    # read_gray as np.asarray(Image.open(path), np.uint8) (the JAX package's reader) gives it
    np.testing.assert_array_equal(read_gray(str(tmp_path / "g.png")), gray[..., 0].astype(np.uint8))
    np.testing.assert_array_equal(read_rgb(str(tmp_path / "c.png")), (rgb >> 8).astype(np.uint8))


def test_refusals_name_the_file(tmp_path):
    arr = RNG.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
    interlaced = _png(arr.reshape(H, -1), W, H, 8, 2, 3, interlace=1)
    path = tmp_path / "interlaced.png"
    path.write_bytes(interlaced)
    with pytest.raises(ValueError, match="interlaced.png: interlaced"):
        png.decode_png_file(str(path))
    raw = bytearray(_filter(arr.reshape(H, -1), 3, [0] * H))
    raw[5 * (W * 3 + 1)] = 7  # row 5: filter type 7
    header = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
    blob = header + _chunk(b"IDAT", zlib.compress(bytes(raw))) + _chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="x.png: row 5 has filter type 7"):
        png.decode_png(blob, name="x.png")
    truncated = header + _chunk(b"IDAT", zlib.compress(bytes(raw[:-10]))) + _chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="y.png: .* bytes of image data"):
        png.decode_png(truncated, name="y.png")
    assert png.decode_png(b"GIF89a....") is None


def test_unfilter_is_chosen_by_device():
    """One switch for every host op: the device's ``HostOps`` carries its
    unfilter."""
    assert host_ops_for("cpu").unfilter is png.unfilter_plain
    assert host_ops_for("cuda").unfilter is unfilter_native
    with pytest.raises(ValueError):
        host_ops_for("mps")
