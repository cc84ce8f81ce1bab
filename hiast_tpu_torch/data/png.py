"""PNG codec in numpy and the standard library's zlib.

The port's replacement for what ``hiast_tpu/data/native_ops.py`` gives the
data path, without a C++ library that needs zlib's headers:

- ``encode_png`` writes 8- or 16-bit gray, gray+alpha, RGB or RGBA images,
  and palette images at the bit depth PIL picks for the palette's length
  (1, 2, 4 or 8 bits), with the first row unfiltered and every later
  row Up-filtered, deflated at zlib level 1 — the layout of the JAX
  package's native label encoder (label maps are mostly runs, so Up rows
  deflate to almost nothing).
- ``decode_png`` reads every non-interlaced PNG: gray at 1, 2, 4, 8 and 16
  bits, gray+alpha, RGB and RGBA at 8 and 16 bits, and palette images at
  1, 2, 4 and 8 bits (looked up in PLTE, or their indices with
  ``palette=False``), with rows under any of the five filters.  A 16-bit
  file comes back as uint16 (PNG stores it big-endian), every other as
  uint8; gray below 8 bits is scaled to 0-255.  Interlaced files and
  malformed ones raise ``ValueError`` naming the file; bytes that are not a
  PNG give None (callers hand such files to PIL).

Python's zlib inflates; the rows are then unfiltered by one of two
functions of the same contract, ``unfilter(raw [h, 1 + stride], bpp) ->
[h, stride]``: ``unfilter_plain`` in numpy and Python (the Average and
Paeth filters are serial along a row, so those rows take a Python loop)
and ``unfilter_native``, the host C function of ``csrc/png_unfilter.cu``
loaded with ctypes.  ``unfilter_for`` picks one from the device a run
trains or serves on; nothing falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Callable

import numpy as np

from hiast_tpu_torch.ops.cuda import build

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # samples per pixel -> colour type, for encoding

Unfilter = Callable[[np.ndarray, int], np.ndarray]


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(arr: np.ndarray, level: int = 1, palette: np.ndarray | None = None) -> bytes:
    """uint8 or uint16 [H, W] or [H, W, C] (C in 1..4) -> PNG bytes, at 8
    or 16 bits a sample (16-bit samples stored big-endian).  With
    ``palette`` (uint8 [N, 3]) a uint8 [H, W] array is written as the
    indices of a palette image at the depth PIL's PNG writer picks for N
    entries: 1 bit up to 2, 2 up to 4, 4 up to 16, else 8.  Below 8 bits an
    index keeps its low bits, as in PIL's file (255 is 15 at 4 bits)."""
    depth = 16 if arr.dtype == np.uint16 else 8
    arr = np.ascontiguousarray(arr, ">u2" if depth == 16 else np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"cannot encode an array of shape {arr.shape} as PNG")
    h, w, c = arr.shape
    rows = arr.reshape(h, w * c).view(np.uint8)
    colour, plte = _COLOUR_TYPE[c], b""
    if palette is not None:
        if depth != 8 or c != 1:
            raise ValueError("a palette image holds uint8 [H, W] indices")
        palette = np.ascontiguousarray(palette, np.uint8).reshape(-1, 3)
        colour, plte = 3, _chunk(b"PLTE", palette.tobytes())
        n = len(palette)
        depth = 1 if n <= 2 else 2 if n <= 4 else 4 if n <= 16 else 8
        if depth < 8:  # most significant bits first, each row padded to a byte
            bits = np.unpackbits(rows[:, :, None], axis=2)[:, :, 8 - depth:]
            rows = np.packbits(bits.reshape(h, w * depth), axis=1)
    raw = np.empty((h, rows.shape[1] + 1), np.uint8)
    raw[:, 0] = 2  # Up
    raw[0, 0] = 0  # None: the first row has no row above it
    raw[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=raw[1:, 1:])  # wraps mod 256
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + plte
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, arr: np.ndarray, palette: np.ndarray | None = None) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(arr, palette=palette))


# -- unfiltering ----------------------------------------------------------------
def _serial_row(src: np.ndarray, up: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """One Average (3) or Paeth (4) row: each byte adds a predictor of the
    unfiltered byte ``bpp`` to its left."""
    src, up = src.tolist(), up.tolist()
    row = [0] * len(src)
    for x, s in enumerate(src):
        left = row[x - bpp] if x >= bpp else 0
        if kind == 3:
            row[x] = (s + ((left + up[x]) >> 1)) & 255
            continue
        corner = up[x - bpp] if x >= bpp else 0
        p = left + up[x] - corner
        pa, pb, pc = abs(p - left), abs(p - up[x]), abs(p - corner)
        pred = left if pa <= pb and pa <= pc else (up[x] if pb <= pc else corner)
        row[x] = (s + pred) & 255
    return np.asarray(row, np.uint8)


def unfilter_plain(raw: np.ndarray, bpp: int) -> np.ndarray:
    """uint8 [h, 1 + stride] filtered rows -> uint8 [h, stride], in numpy
    (None, Sub, Up) and Python (Average, Paeth)."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    filters, data = raw[:, 0], raw[:, 1:]
    bad = np.flatnonzero(filters > 4)
    if bad.size:
        raise ValueError(f"row {int(bad[0])} has filter type {int(filters[bad[0]])}")
    out = np.empty((h, stride), np.uint8)
    zero = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, up = int(filters[y]), (out[y - 1] if y > 0 else zero)
        if kind == 0:
            out[y] = data[y]
        elif kind == 1:  # running sum along the row, per byte of a pixel
            out[y] = np.cumsum(data[y].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            np.add(data[y], up, out=out[y])
        else:
            out[y] = _serial_row(data[y], up, bpp, kind)
    return out


_native: list = []
_native_lock = threading.Lock()


def _native_fn():
    with _native_lock:
        if not _native:
            fn = build.load("png_unfilter").png_unfilter
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
            fn.restype = ctypes.c_int
            _native.append(fn)
        return _native[0]


def unfilter_native(raw: np.ndarray, bpp: int) -> np.ndarray:
    """``unfilter_plain``'s contract, by ``csrc/png_unfilter.cu`` (built at
    first use; a failed build raises).  ctypes releases the interpreter lock
    for the call, so loader threads unfilter in parallel."""
    fn = _native_fn()
    raw = np.ascontiguousarray(raw, np.uint8)
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    status = fn(raw.ctypes.data, out.ctypes.data, h, stride, int(bpp))
    if status:
        raise ValueError(f"row {status - 1} has filter type {int(raw[status - 1, 0])}")
    return out


def unfilter_for(device_type: str) -> Unfilter:
    """The unfilter of a run on a ``device_type`` ('cuda' or 'cpu') device:
    the native one beside a card, the plain one on the CPU (the tests)."""
    if device_type == "cuda":
        return unfilter_native
    if device_type == "cpu":
        return unfilter_plain
    raise ValueError(f"no PNG unfilter for device type {device_type!r}")


# -- decoding -------------------------------------------------------------------
def _unpack_bits(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """[h, stride] bytes of 1-, 2- or 4-bit samples, most significant first
    -> uint8 [h, width] sample values."""
    bits = np.unpackbits(rows, axis=1)[:, : width * depth].reshape(rows.shape[0], width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)


def decode_png(blob: bytes, unfilter: Unfilter = unfilter_plain, palette: bool = True,
               name: str = "PNG data") -> np.ndarray | None:
    """PNG bytes -> [H, W] or [H, W, C] uint8 (uint16 at 16 bits); None when
    ``blob`` is not a PNG.  A palette image gives RGB [H, W, 3], or its
    indices [H, W] with ``palette=False``."""
    if blob[:8] != _SIGNATURE:
        return None
    header, plte, idat, pos = None, None, [], 8
    while pos + 12 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        body = blob[pos + 8 : pos + 8 + length]
        if kind == b"IHDR" and len(body) == 13:
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{name}: not a whole PNG (no IHDR or no IDAT chunk)")
    w, h, depth, colour, _, _, interlace = header
    if interlace != 0:
        raise ValueError(f"{name}: interlaced (Adam7) PNGs are not read")
    if depth not in _DEPTHS.get(colour, ()):
        raise ValueError(f"{name}: colour type {colour} at bit depth {depth} is not a valid PNG")
    c = _CHANNELS[colour]
    stride = (w * c * depth + 7) // 8
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt image data ({e})") from None
    if raw.size != h * (stride + 1):
        raise ValueError(f"{name}: {raw.size} bytes of image data, expected {h * (stride + 1)}")
    try:
        rows = unfilter(raw.reshape(h, stride + 1), (c * depth + 7) // 8)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if depth == 16:
        out = rows.view(">u2").astype(np.uint16).reshape(h, w, c)
    elif depth == 8:
        out = rows.reshape(h, w, c)
    else:
        out = _unpack_bits(rows, depth, w)[:, :, None]
        if colour == 0:  # gray below 8 bits, scaled to 0..255
            out = out * np.uint8(255 // ((1 << depth) - 1))
    if colour == 3 and palette:
        if plte is None:
            raise ValueError(f"{name}: a palette image without a PLTE chunk")
        table = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        if int(out.max(initial=0)) >= len(table):
            raise ValueError(f"{name}: a palette index beyond the {len(table)} PLTE entries")
        return table[out[:, :, 0]]
    return out[:, :, 0] if c == 1 else out


def decode_png_file(path: str, unfilter: Unfilter = unfilter_plain, palette: bool = True) -> np.ndarray | None:
    """``decode_png`` of a file; None for a file that is not a ``.png``."""
    if not path.endswith(".png"):
        return None
    with open(path, "rb") as f:
        return decode_png(f.read(), unfilter, palette, name=path)
