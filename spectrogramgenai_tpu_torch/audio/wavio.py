"""WAV loading and writing and the reference's clip-slicing semantics (no librosa).

Copy of ``spectrogramgenai_tpu/audio/wavio.py`` on ``scipy.io.wavfile``.
librosa.core.load(sr=None) parity: PCM integer formats scale to [-1, 1]
float32, multi-channel files are averaged to mono, and a ``target_sr``
resamples with scipy's ``resample_poly`` at the gcd ratio.
Slicing follows SpecDataset (reference helpers.py:83-87): a ``clip_seconds``
window from int(begin_time); if that runs off the end, the window ending at
int(end_time); a file shorter than the window is zero-padded. The mixing
dataset's window (``fixed_window``) is peak-normalised.
"""

from __future__ import annotations

import os
from math import gcd

import numpy as np
from scipy.io import wavfile

_INT_SCALE = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0, np.dtype(np.uint8): 128.0}


def load_wav(path: str, target_sr: int | None = None) -> tuple[np.ndarray, int]:
    """→ (mono float32 waveform in [-1, 1], sample_rate), resampled to ``target_sr`` if given."""
    sr, data = wavfile.read(path)
    if data.dtype in _INT_SCALE:
        scale = _INT_SCALE[data.dtype]
        if data.dtype == np.uint8:
            data = data.astype(np.float32) - 128.0
        data = data.astype(np.float32) / scale
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if target_sr is not None and target_sr != sr:
        from scipy.signal import resample_poly

        g = gcd(int(target_sr), int(sr))
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
        sr = target_sr
    return data, int(sr)


def slice_clip(wav: np.ndarray, sr: int, begin_time: float, end_time: float,
               clip_seconds: float = 6.0) -> np.ndarray:
    """Reference 6-s window logic (helpers.py:84-87)."""
    n = int(clip_seconds * sr)
    start = int(int(begin_time) * sr)
    clip = wav[start : start + n]
    if len(clip) != n:
        end = int(int(end_time) * sr)
        clip = wav[max(0, end - n) : end]
    if len(clip) < n:  # degenerate short files: pad with zeros
        clip = np.pad(clip, (0, n - len(clip)))
    return clip


def normalize_peak(wav: np.ndarray) -> np.ndarray:
    """librosa.util.normalize: divide by max |x| (the mixing dataset's clips)."""
    peak = np.abs(wav).max()
    return wav / peak if peak > 0 else wav


def fixed_window(wav: np.ndarray, sr: int, start_s: float, num_samples: int) -> np.ndarray:
    """The mixing dataset's window: ``num_samples`` from ``start_s``; the
    file's tail if that runs off the end; tiled if the file is shorter; then
    peak-normalised."""
    start = int(start_s * sr)
    clip = wav[start : start + num_samples]
    if len(clip) != num_samples:
        clip = wav[max(0, len(wav) - num_samples):]
    if len(clip) < num_samples:
        reps = num_samples // max(1, len(clip)) + 1
        clip = np.tile(clip, reps)[:num_samples]
    return normalize_peak(clip)


def save_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """Write mono float [-1, 1] → 16-bit PCM WAV (clipping out-of-range)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pcm = (np.clip(np.asarray(wav, np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)
    wavfile.write(path, int(sr), pcm)
