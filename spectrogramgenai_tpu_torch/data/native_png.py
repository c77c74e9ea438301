"""ctypes binding of the batch PNG codec (``csrc/png_batch.cpp``).

Counterpart of ``spectrogramgenai_tpu/data/native_png.py``. The library is
built with g++ at first use by ``ops/_build.py``; a failed build raises.

* ``load_png_batch_gray``: a batch of PNG files → uint8 grayscale, bit-equal
  to PIL's ``convert("L")``. A row the decoder does not read (16-bit,
  interlaced, another size, not a PNG) comes back with ok False; the caller
  decodes it another way, and ``load_png_batch_gray.rejected`` counts it.
* ``encode_png_batch_rgb`` / ``save_png_batch_rgb``: RGB images → PNG bytes or
  files (Sub filter, zlib level 3). A row that fails raises: nothing else
  encodes or writes it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from spectrogramgenai_tpu_torch.ops import _build

_P = ctypes.POINTER
_u8p = _P(ctypes.c_ubyte)
ENCODE_LEVEL = 3  # zlib level of the encoders (the JAX package's)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its functions' argument and result types declared."""
    lib = _build.load("png_batch")
    lib.png_batch_load_gray.restype = ctypes.c_int
    lib.png_batch_load_gray.argtypes = [_P(ctypes.c_char_p), ctypes.c_int, _u8p, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_int]
    lib.png_batch_encode_bound.restype = ctypes.c_longlong
    lib.png_batch_encode_bound.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.png_batch_encode_rgb.restype = ctypes.c_int
    lib.png_batch_encode_rgb.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p,
                                         ctypes.c_longlong, _P(ctypes.c_longlong), ctypes.c_int, ctypes.c_int]
    lib.png_batch_save_rgb.restype = ctypes.c_int
    lib.png_batch_save_rgb.argtypes = [_P(ctypes.c_char_p), ctypes.c_int, _u8p, ctypes.c_int, ctypes.c_int,
                                       _u8p, ctypes.c_int, ctypes.c_int]
    return lib


def _c_paths(paths: list[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def load_png_batch_gray(paths: list[str], height: int, width: int,
                        num_threads: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Decode (height, width) PNGs → (uint8 (n, height, width), ok bool (n,)); rows not ok are zero."""
    n = len(paths)
    out = np.zeros((n, height, width), np.uint8)
    ok = np.zeros(n, np.uint8)
    if n:
        _lib().png_batch_load_gray(_c_paths(paths), n, out.ctypes.data_as(_u8p), height * width, height, width,
                                   ok.ctypes.data_as(_u8p), num_threads)
    load_png_batch_gray.rejected += int(n - ok.sum())
    return out, ok.astype(bool)


load_png_batch_gray.rejected = 0  # rows handed back undecoded since the count was last set to 0


def _rgb_batch(rgb: np.ndarray) -> np.ndarray:
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 4 or rgb.shape[-1] != 3:
        raise ValueError(f"expected (n, H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    return rgb


def encode_png_batch_rgb(rgb: np.ndarray, num_threads: int = 8, level: int = ENCODE_LEVEL) -> list[bytes]:
    """(n, H, W, 3) uint8 → one RGB PNG's bytes per image, in memory."""
    rgb = _rgb_batch(rgb)
    n, h, w = rgb.shape[:3]
    if n == 0:
        return []
    lib = _lib()
    capacity = lib.png_batch_encode_bound(h, w)
    out = np.empty((n, capacity), np.uint8)
    lens = np.empty(n, np.int64)
    good = lib.png_batch_encode_rgb(rgb.ctypes.data_as(_u8p), n, h, w, out.ctypes.data_as(_u8p), capacity,
                                    lens.ctypes.data_as(_P(ctypes.c_longlong)), num_threads, level)
    if good != n:
        raise RuntimeError(f"PNG encode failed for {n - good} of {n} images")
    return [out[i, :lens[i]].tobytes() for i in range(n)]


def save_png_batch_rgb(rgb: np.ndarray, paths: list[str], num_threads: int = 8, level: int = ENCODE_LEVEL) -> None:
    """Write each (H, W, 3) uint8 image of ``rgb`` as an RGB PNG to its path (the directories must exist)."""
    rgb = _rgb_batch(rgb)
    n = len(paths)
    if rgb.shape[0] != n:
        raise ValueError(f"{rgb.shape[0]} images for {n} paths")
    if n == 0:
        return
    ok = np.zeros(n, np.uint8)
    _lib().png_batch_save_rgb(_c_paths(paths), n, rgb.ctypes.data_as(_u8p), rgb.shape[1], rgb.shape[2],
                              ok.ctypes.data_as(_u8p), num_threads, level)
    if not ok.all():
        failed = [p for p, good in zip(paths, ok) if not good]
        raise OSError(f"PNG write failed for {len(failed)} of {n} files, e.g. {failed[0]}")
