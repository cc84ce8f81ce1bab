"""The data path's pixel work, in two interchangeable sets: plain numpy
and the port's own C++ library.

``HostOps`` bundles the five functions that datasets, augs and
preprocessors call on every sample: the PNG row ``unfilter``,
``crop_flip_resize`` (the 'MS' / 'OMS' crop), ``resize_linear`` and
``resize_nearest`` ('PRS', 'DACS', FDA's target, donors and pseudo-labels
of another size) and ``paste_hard_classes`` (CopyPaste, ClassMix).
``PLAIN`` holds the numpy and Python versions of ``data/png.py``,
``data/augment.py`` and ``data/copy_paste.py``, which are the
specification; ``NATIVE`` holds the functions of ``csrc/host_ops.cpp``,
built at first call by ``ops/cuda/build.py`` with the host C++ compiler
(a failed build raises), which give the same bytes.  ``host_ops_for``
picks one from the device a run trains or serves on: the native set beside
a card, the plain one on the CPU (the tests); nothing falls back from one
to the other.

The library is loaded with ``ctypes.CDLL``, so each call releases the
interpreter lock and the training stream's loader threads run in
parallel.  C reads and writes out of bounds silently, so each wrapper
checks shapes, dtypes and the crop's bounds first.  The outputs written in
place (the paste's image, label and mask) must be C-contiguous, writable
uint8 arrays: anything else raises, since a copy would drop the paste.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np

from hiast_tpu_torch.data import augment, copy_paste, png
from hiast_tpu_torch.ops.cuda import build

_I64 = ctypes.c_int64
_P = ctypes.c_void_p
_SIGNATURES = {
    "png_unfilter": ([_P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int], ctypes.c_int),
    "crop_flip_resize_u8": ([_P, _I64, _I64, _I64, _I64, _I64, _I64, ctypes.c_int, _P, _I64, _I64], None),
    "crop_flip_resize_nearest_u8": ([_P, _I64, _I64, _I64, _I64, _I64, ctypes.c_int, _P, _I64, _I64], None),
    "resize_linear_u8": ([_P, _I64, _I64, _I64, _P, _I64, _I64], None),
    "resize_nearest_u8": ([_P, _I64, _I64, _I64, _P, _I64, _I64], None),
    "paste_hard_classes": ([_P, _P, _P, _P, _P, _P, _I64, _I64], None),
}

_lib: list = []
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    """``csrc/host_ops.cpp``'s library with every function's C signature
    declared, built and loaded at the first call."""
    with _lib_lock:
        if not _lib:
            lib = build.load("host_ops")
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib.append(lib)
        return _lib[0]


def _input(a: np.ndarray, name: str, ndim: tuple[int, ...]) -> np.ndarray:
    if not isinstance(a, np.ndarray) or a.dtype != np.uint8 or a.ndim not in ndim:
        raise ValueError(f"{name} must be a uint8 array of {' or '.join(map(str, ndim))} dimensions, got "
                         f"{getattr(a, 'dtype', type(a).__name__)} {getattr(a, 'shape', '')}")
    return np.ascontiguousarray(a)


def _in_place(a: np.ndarray, name: str) -> np.ndarray:
    if not (isinstance(a, np.ndarray) and a.dtype == np.uint8 and a.flags.c_contiguous and a.flags.writeable):
        raise ValueError(f"{name} is written in place and must be a C-contiguous, writable uint8 array")
    return a


def _channels(a: np.ndarray) -> int:
    return a.shape[2] if a.ndim == 3 else 1


def _check_size(oh: int, ow: int) -> None:
    if oh < 1 or ow < 1:
        raise ValueError(f"output size {oh}x{ow} is empty")


def unfilter_native(raw: np.ndarray, bpp: int) -> np.ndarray:
    """``png.unfilter_plain``'s contract: uint8 [h, 1 + stride] filtered
    rows -> uint8 [h, stride]."""
    raw = _input(raw, "raw", (2,))
    h, stride = raw.shape[0], raw.shape[1] - 1
    if stride < 0 or bpp < 1:
        raise ValueError(f"{raw.shape[1]} bytes a row, {bpp} a pixel")
    out = np.empty((h, stride), np.uint8)
    status = _library().png_unfilter(raw.ctypes.data, out.ctypes.data, h, stride, int(bpp))
    if status:
        raise ValueError(f"row {status - 1} has filter type {int(raw[status - 1, 0])}")
    return out


def crop_flip_resize_native(img, lbl, y0: int, x0: int, ch: int, cw: int, flip: bool, oh: int, ow: int):
    """``augment.crop_flip_resize``'s contract: uint8 [H, W, C] image and
    [H, W] label -> [oh, ow, C] and [oh, ow]."""
    img = _input(img, "img", (3,))
    lbl = _input(lbl, "lbl", (2,))
    h, w, c = img.shape
    if lbl.shape != (h, w):
        raise ValueError(f"label {lbl.shape} does not match image {img.shape}")
    if not (0 <= y0 and 0 <= x0 and 1 <= ch and 1 <= cw and y0 + ch <= h and x0 + cw <= w):
        raise ValueError(f"crop {ch}x{cw} at ({y0}, {x0}) is not inside the {h}x{w} image")
    _check_size(oh, ow)
    out_img = np.empty((oh, ow, c), np.uint8)
    out_lbl = np.empty((oh, ow), np.uint8)
    lib = _library()
    lib.crop_flip_resize_u8(img.ctypes.data, w, c, y0, x0, ch, cw, int(bool(flip)), out_img.ctypes.data, oh, ow)
    lib.crop_flip_resize_nearest_u8(lbl.ctypes.data, w, y0, x0, ch, cw, int(bool(flip)), out_lbl.ctypes.data, oh, ow)
    return out_img, out_lbl


def resize_linear_native(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``augment.resize_linear``'s contract: uint8 [H, W] or [H, W, C]."""
    img = _input(img, "img", (2, 3))
    _check_size(out_h, out_w)
    out = np.empty((out_h, out_w) + img.shape[2:], np.uint8)
    _library().resize_linear_u8(img.ctypes.data, img.shape[0], img.shape[1], _channels(img), out.ctypes.data,
                                out_h, out_w)
    return out


def resize_nearest_native(lbl: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``augment.resize_nearest``'s contract: uint8 [H, W] or [H, W, C]."""
    lbl = _input(lbl, "lbl", (2, 3))
    _check_size(out_h, out_w)
    out = np.empty((out_h, out_w) + lbl.shape[2:], np.uint8)
    _library().resize_nearest_u8(lbl.ctypes.data, lbl.shape[0], lbl.shape[1], _channels(lbl), out.ctypes.data,
                                 out_h, out_w)
    return out


def paste_hard_classes_native(img, lbl, cp_mask, donor_img, donor_lbl, hard_lut) -> None:
    """``copy_paste.paste_hard_classes``'s contract, in one pass: ``img``
    [H, W, C], ``lbl`` and ``cp_mask`` [H, W] written in place where the
    [256] table (bool or uint8) is true at the donor's label."""
    img, lbl, cp_mask = _in_place(img, "img"), _in_place(lbl, "lbl"), _in_place(cp_mask, "cp_mask")
    donor_img = _input(donor_img, "donor_img", (3,))
    donor_lbl = _input(donor_lbl, "donor_lbl", (2,))
    lut = np.ascontiguousarray(hard_lut, np.uint8)
    if lut.shape != (256,):
        raise ValueError(f"the class table must have 256 entries, got {lut.shape}")
    if img.ndim != 3 or img.shape != donor_img.shape or not (
            lbl.shape == cp_mask.shape == donor_lbl.shape == img.shape[:2]):
        raise ValueError(f"shapes differ: img {img.shape}, lbl {lbl.shape}, cp_mask {cp_mask.shape}, "
                         f"donor_img {donor_img.shape}, donor_lbl {donor_lbl.shape}")
    _library().paste_hard_classes(img.ctypes.data, lbl.ctypes.data, cp_mask.ctypes.data, donor_img.ctypes.data,
                                  donor_lbl.ctypes.data, lut.ctypes.data, lbl.size, img.shape[2])


@dataclass(frozen=True)
class HostOps:
    """One set of the data path's pixel functions (module docstring)."""

    unfilter: png.Unfilter
    crop_flip_resize: Callable
    resize_linear: Callable[[np.ndarray, int, int], np.ndarray]
    resize_nearest: Callable[[np.ndarray, int, int], np.ndarray]
    paste_hard_classes: Callable[..., None]


PLAIN = HostOps(png.unfilter_plain, augment.crop_flip_resize, augment.resize_linear,
                augment.resize_nearest, copy_paste.paste_hard_classes)
NATIVE = HostOps(unfilter_native, crop_flip_resize_native, resize_linear_native,
                 resize_nearest_native, paste_hard_classes_native)


def host_ops_for(device_type: str) -> HostOps:
    """The host ops of a run on a ``device_type`` ('cuda' or 'cpu') device:
    the native set beside a card, the plain one on the CPU (the tests)."""
    if device_type == "cuda":
        return NATIVE
    if device_type == "cpu":
        return PLAIN
    raise ValueError(f"no host ops for device type {device_type!r}")
