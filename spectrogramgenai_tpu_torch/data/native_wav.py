"""ctypes binding of the batch WAV decoder and clip slicer (``csrc/wav_batch.cpp``).

Counterpart of ``spectrogramgenai_tpu/data/native_wav.py``. The library is
built with g++ at first use by ``ops/_build.py`` (a failed build raises;
there is no Python fallback). Each row is bit-equal to
``audio/wavio.load_wav`` + ``slice_clip``, which the JAX native decoder is
not: that one reads 8-bit PCM as silence, clamps a window that runs past the
end of the file to the file, and caps a row at 6 s of 48 kHz. Here a row's
length is its own file's ``int(clip_seconds · rate)``: the rates are read
from the headers first and the buffer is as wide as the widest row.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from spectrogramgenai_tpu_torch.ops import _build

_P = ctypes.POINTER


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its functions' argument and result types declared."""
    lib = _build.load("wav_batch")
    lib.wav_batch_rates.restype = ctypes.c_int
    lib.wav_batch_rates.argtypes = [_P(ctypes.c_char_p), ctypes.c_int, _P(ctypes.c_int), ctypes.c_int]
    lib.wav_batch_load.restype = ctypes.c_int
    lib.wav_batch_load.argtypes = [
        _P(ctypes.c_char_p), ctypes.c_int, _P(ctypes.c_longlong), _P(ctypes.c_longlong), ctypes.c_double,
        _P(ctypes.c_float), ctypes.c_longlong, _P(ctypes.c_int), _P(ctypes.c_longlong), ctypes.c_int,
    ]
    return lib


def _c_paths(paths: list[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def wav_rates(paths: list[str], num_threads: int = 8) -> np.ndarray:
    """Each file's sample rate from its header, int32 (n,); 0 for a file the decoder does not read."""
    rates = np.zeros(len(paths), np.int32)
    if paths:
        _lib().wav_batch_rates(_c_paths(paths), len(paths), rates.ctypes.data_as(_P(ctypes.c_int)), num_threads)
    return rates


def load_wav_batch(paths: list[str], begin_times, end_times, clip_seconds: float = 6.0,
                   num_threads: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Decode and slice a batch → (float32 (n, width) clips, int32 (n,) sample rates).

    Row i holds ``slice_clip(*load_wav(paths[i]), begin_times[i],
    end_times[i], clip_seconds)`` in its first ``int(clip_seconds ·
    rates[i])`` samples and zeros after; ``width`` is the longest such row. A
    file that cannot be read gives rate 0 and a zero row.
    """
    n = len(paths)
    begin = np.asarray([int(b) for b in begin_times], np.int64)  # int(begin_time), as slice_clip
    end = np.asarray([int(e) for e in end_times], np.int64)
    if not (len(begin) == len(end) == n):
        raise ValueError(f"{n} paths for {len(begin)} begin and {len(end)} end times")
    rates = wav_rates(paths, num_threads)
    width = max((int(clip_seconds * int(sr)) for sr in rates if sr > 0), default=0)
    out = np.zeros((n, width), np.float32)
    got_rates = np.zeros(n, np.int32)
    lengths = np.zeros(n, np.int64)
    if n and width:
        _lib().wav_batch_load(
            _c_paths(paths), n, begin.ctypes.data_as(_P(ctypes.c_longlong)),
            end.ctypes.data_as(_P(ctypes.c_longlong)), float(clip_seconds), out.ctypes.data_as(_P(ctypes.c_float)),
            width, got_rates.ctypes.data_as(_P(ctypes.c_int)), lengths.ctypes.data_as(_P(ctypes.c_longlong)),
            num_threads)
    return out, got_rates
