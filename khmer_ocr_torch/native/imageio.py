"""ctypes wrapper of the native image loader (imageio.cpp).

Pillow-exact decode + grayscale + BILINEAR resize in C++ (libpng, libjpeg),
with thread-pool batch APIs and entry points for in-memory images.
``load_resize_gray(..., as_uint8=True)`` gives what
``Image.open(path).convert("L").resize(..., BILINEAR)`` gives, bit for bit
for PNG (JPEG within 1, by the libjpeg build), off the GIL; by default it
returns those pixels as float32 ``uint8 / 255``, as the JAX package's does.
The library builds with g++ at first use into ``khmer_ocr_torch/_build/``
(native/build.py: each process builds to a name of its own and renames it
into place). Where g++, libpng or libjpeg is missing,
``load_imageio_library`` returns None and every function here returns None:
the Preprocessor then reads the lines through PIL, whose pixels are the
same. That is a host path, not a device.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from .build import build_library

_SRC = Path(__file__).resolve().parent / "imageio.cpp"
LINK = ("-lpng", "-ljpeg", "-lz")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_FAILED: str | None = None  # why the library is unavailable, once a build has failed
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


def load_imageio_library() -> ctypes.CDLL | None:
    """Build (once) and load the loader; None when it cannot be built here."""
    global _LIB, _FAILED
    with _LOCK:
        if _LIB is not None or _FAILED is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(build_library(_SRC, LINK)))
        except (RuntimeError, OSError, FileNotFoundError) as e:
            _FAILED = f"{type(e).__name__}: {e}"
            return None
        lib.kh_load_resize_gray.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P, _I32P]
        lib.kh_load_resize_gray.restype = ctypes.c_int
        lib.kh_load_resize_gray_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_int, _U8P, _I32P, _I32P, ctypes.c_int]
        lib.kh_load_resize_gray_batch.restype = None
        lib.kh_resize_gray_mem.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P, _I32P]
        lib.kh_resize_gray_mem.restype = ctypes.c_int
        lib.kh_resize_gray_mem_batch.argtypes = [ctypes.POINTER(_U8P), _I32P, _I32P, _I32P,
                                                 ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
                                                 ctypes.c_int, ctypes.c_int, _U8P, _I32P, _I32P, ctypes.c_int]
        lib.kh_resize_gray_mem_batch.restype = None
        _LIB = lib
        return lib


def unavailable_reason() -> str | None:
    """Why ``load_imageio_library`` returned None (the compiler's message), or None."""
    return _FAILED


def _pixels(out: np.ndarray, width: int, as_uint8: bool) -> np.ndarray:
    """The first ``width`` columns of a decoded row block: uint8, or float32 uint8 / 255."""
    return np.ascontiguousarray(out[:, :width]) if as_uint8 else out[:, :width].astype(np.float32) / 255.0


def load_resize_gray(path, out_h: int = 48, min_w: int = 50, cap_w: int = 10768,
                     as_uint8: bool = False) -> np.ndarray | None:
    """Decode and resize one image file -> (out_h, min(W, cap_w)), W =
    max(min_w, int(out_h * aspect)): float32 in [0, 1] (exactly uint8 / 255),
    or the uint8 pixels with ``as_uint8``; None when the library is
    unavailable or the decode fails (a missing file, an exotic format)."""
    lib = load_imageio_library()
    if lib is None:
        return None
    out = np.empty((out_h, cap_w), np.uint8)
    w = ctypes.c_int32(0)
    if lib.kh_load_resize_gray(str(path).encode(), out_h, min_w, cap_w, out.ctypes.data_as(_U8P), ctypes.byref(w)):
        return None
    return _pixels(out, min(w.value, cap_w), as_uint8)


def load_resize_gray_batch(paths, out_h: int = 48, min_w: int = 50, cap_w: int = 10768, n_threads: int = 0,
                           out: np.ndarray | None = None):
    """Decode and resize image files on ``n_threads`` threads (0: one a core)
    -> (buf (n, out_h, cap_w) uint8, widths (n,) int32, errs (n,) int32), or
    None when the library is unavailable. widths[i] is the natural resized
    width, which may exceed cap_w (valid columns: min(width, cap_w));
    errs[i] != 0: image i failed. ``out``: a (>= n, out_h, cap_w) buffer to
    decode into and return a view of (a reused slab is spared the page faults
    of a fresh allocation; only the first widths[i] columns of a row are
    written, and only those are read)."""
    lib = load_imageio_library()
    if lib is None:
        return None
    n = len(paths)
    bufs = out[:n] if out is not None and out.shape[0] >= n and out.shape[1:] == (out_h, cap_w) else \
        np.empty((n, out_h, cap_w), np.uint8)
    widths = np.zeros(n, np.int32)
    errs = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.kh_load_resize_gray_batch(arr, n, out_h, min_w, cap_w, bufs.ctypes.data_as(_U8P),
                                  widths.ctypes.data_as(_I32P), errs.ctypes.data_as(_I32P), n_threads)
    return bufs, widths, errs


def _as_mem_view(img):
    """One in-memory image -> (uint8 (H, W) or (H, W, 3|4) array with dense
    rows, channels), or None when the native path cannot take it."""
    if not isinstance(img, np.ndarray) or img.dtype != np.uint8 or img.ndim not in (2, 3):
        return None
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    channels = 1 if img.ndim == 2 else img.shape[2]
    if channels not in (1, 3, 4) or img.shape[0] <= 0 or img.shape[1] <= 0:
        return None
    if img.strides[-1] != 1 or (img.ndim == 3 and img.strides[1] != channels):
        img = np.ascontiguousarray(img)
    return img, channels


def resize_gray_mem(img: np.ndarray, out_h: int = 48, min_w: int = 50, cap_w: int = 10768,
                    as_uint8: bool = False) -> np.ndarray | None:
    """Grayscale and resize one in-memory uint8 image (H, W) or (H, W, 1|3|4)
    -> (out_h, min(W', cap_w)), what ``Image.fromarray(img).convert("L")
    .resize(..., BILINEAR)`` gives: float32 uint8 / 255, or uint8 with
    ``as_uint8``; None when the library is unavailable or the array is not
    one it takes."""
    lib = load_imageio_library()
    view = _as_mem_view(img)
    if lib is None or view is None:
        return None
    img, channels = view
    out = np.empty((out_h, cap_w), np.uint8)
    w = ctypes.c_int32(0)
    if lib.kh_resize_gray_mem(img.ctypes.data_as(_U8P), img.shape[0], img.shape[1], channels, img.strides[0], out_h,
                              min_w, cap_w, out.ctypes.data_as(_U8P), ctypes.byref(w)):
        return None
    return _pixels(out, min(w.value, cap_w), as_uint8)


def resize_gray_mem_batch(images, out_h: int = 48, min_w: int = 50, cap_w: int = 10768, n_threads: int = 0,
                          out: np.ndarray | None = None):
    """Grayscale and resize in-memory images on ``n_threads`` threads (0: one
    a core) -> (buf (n, out_h, cap_w) uint8, widths (n,) int32, errs (n,)
    int32), or None when the library is unavailable; each row as
    ``resize_gray_mem(..., as_uint8=True)`` gives it in its first
    min(widths[i], cap_w) columns. errs[i] = 2: image i is not an array the
    native path takes (another nonzero value: its resize failed). ``out`` as
    in ``load_resize_gray_batch``."""
    lib = load_imageio_library()
    if lib is None:
        return None
    n = len(images)
    bufs = out[:n] if out is not None and out.shape[0] >= n and out.shape[1:] == (out_h, cap_w) else \
        np.empty((n, out_h, cap_w), np.uint8)
    widths = np.zeros(n, np.int32)
    errs = np.full(n, 2, np.int32)
    views = [_as_mem_view(img) for img in images]
    idx = [i for i, v in enumerate(views) if v is not None]
    if idx:
        m = len(idx)
        keep = [views[i][0] for i in idx]  # the coerced arrays stay alive through the call
        ptrs = (_U8P * m)(*[a.ctypes.data_as(_U8P) for a in keep])
        hs = np.array([a.shape[0] for a in keep], np.int32)
        ws = np.array([a.shape[1] for a in keep], np.int32)
        chs = np.array([views[i][1] for i in idx], np.int32)
        strides = np.array([a.strides[0] for a in keep], np.int64)
        sub = bufs if m == n else np.empty((m, out_h, cap_w), np.uint8)
        sub_w, sub_e = np.zeros(m, np.int32), np.zeros(m, np.int32)
        lib.kh_resize_gray_mem_batch(ptrs, hs.ctypes.data_as(_I32P), ws.ctypes.data_as(_I32P),
                                     chs.ctypes.data_as(_I32P), strides.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                     m, out_h, min_w, cap_w, sub.ctypes.data_as(_U8P), sub_w.ctypes.data_as(_I32P),
                                     sub_e.ctypes.data_as(_I32P), n_threads)
        if m != n:
            bufs[idx] = sub
        widths[idx], errs[idx] = sub_w, sub_e
    return bufs, widths, errs
