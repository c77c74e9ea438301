"""WAV loading and the reference's clip-slicing semantics (no librosa).

Copy of ``load_wav`` and ``slice_clip`` of ``spectrogramgenai_tpu/audio/wavio.py``
on ``scipy.io.wavfile``. librosa.core.load(sr=None) parity: PCM integer
formats scale to [-1, 1] float32, multi-channel files are averaged to mono.
Slicing follows SpecDataset (reference helpers.py:83-87): a ``clip_seconds``
window from int(begin_time); if that runs off the end, the window ending at
int(end_time); a file shorter than the window is zero-padded.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile

_INT_SCALE = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0, np.dtype(np.uint8): 128.0}


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """→ (mono float32 waveform in [-1, 1], sample_rate)."""
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
