"""PNG codec in numpy and the standard library's zlib.

The port's replacement for what ``hiast_tpu/data/native_ops.py`` gives the
generation path, without a C++ library to build:

- ``encode_png`` writes 8-bit gray, RGB or RGBA images with the first row
  unfiltered and every later row Up-filtered, deflated at zlib level 1 — the
  layout of the JAX package's native label encoder (label maps are mostly
  runs, so Up rows deflate to almost nothing).
- ``decode_png`` reads 8-bit non-interlaced gray, gray+alpha, RGB and RGBA
  files whose rows use the None, Sub or Up filters.  It returns None for
  anything else (palette, 16-bit, interlaced, Average/Paeth rows); callers
  then hand the file to PIL, which is imported only for those files.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type -> samples per pixel
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(arr: np.ndarray, level: int = 1) -> bytes:
    """uint8 [H, W] or [H, W, C] (C in 1..4) -> PNG bytes."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"cannot encode an array of shape {arr.shape} as PNG")
    h, w, c = arr.shape
    rows = arr.reshape(h, w * c)
    raw = np.empty((h, w * c + 1), np.uint8)
    raw[:, 0] = 2  # Up
    raw[0, 0] = 0  # None: the first row has no row above it
    raw[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=raw[1:, 1:])  # wraps mod 256
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def decode_png(blob: bytes) -> np.ndarray | None:
    """PNG bytes -> uint8 [H, W] or [H, W, C], or None when unsupported."""
    if blob[:8] != _SIGNATURE:
        return None
    header, idat, pos = None, [], 8
    while pos + 12 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", blob[pos + 8 : pos + 21])
        elif kind == b"IDAT":
            idat.append(blob[pos + 8 : pos + 8 + length])
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        return None
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or interlace != 0 or colour not in _CHANNELS:
        return None
    c = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * c + 1):
        return None
    raw = raw.reshape(h, w * c + 1)
    filters, data = raw[:, 0], raw[:, 1:]
    if np.any(filters > 2):
        return None
    out = np.empty((h, w * c), np.uint8)
    for y in range(h):
        f = filters[y]
        if f == 1:  # Sub: running sum along the row, per channel
            out[y] = np.cumsum(data[y].reshape(w, c), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2 and y > 0:  # Up
            np.add(data[y], out[y - 1], out=out[y])
        else:  # None, or Up on the first row
            out[y] = data[y]
    return out.reshape(h, w) if c == 1 else out.reshape(h, w, c)


def decode_png_file(path: str) -> np.ndarray | None:
    if not path.endswith(".png"):
        return None
    with open(path, "rb") as f:
        return decode_png(f.read())
