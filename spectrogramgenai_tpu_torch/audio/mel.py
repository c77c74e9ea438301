"""Mel filterbank, window and DFT matrices (librosa-compatible, Slaney convention).

NumPy copy of ``spectrogramgenai_tpu/audio/mel.py``, kept here because every
import of the JAX package runs its JAX ``__init__``. The reference pipeline
calls ``librosa.feature.melspectrogram(y, sr, n_mels=256, hop_length=384)``,
i.e. librosa's defaults: ``n_fft=2048``, periodic Hann window, centred frames
with zero padding, power 2, and a Slaney-normalised mel filterbank with
``fmin=0, fmax=sr/2, htk=False``. Everything is computed once per
configuration in float64 and cast; the tests hold each function bit-equal to
the JAX package's.
"""

from __future__ import annotations

import numpy as np

# Slaney auditory-toolbox mel scale constants:
# linear below 1 kHz (200/3 Hz per mel), logarithmic above.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies, htk: bool = False):
    """Convert Hz to mels (Slaney by default, matching librosa's default)."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + frequencies / 700.0)
    mels = frequencies / _F_SP
    log_t = frequencies >= _MIN_LOG_HZ
    mels = np.where(
        log_t,
        _MIN_LOG_MEL + np.log(np.maximum(frequencies, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels, htk: bool = False):
    """Convert mels to Hz (inverse of :func:`hz_to_mel`)."""
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    freqs = _F_SP * mels
    log_t = mels >= _MIN_LOG_MEL
    freqs = np.where(log_t, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)), freqs)
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float, htk: bool = False) -> np.ndarray:
    """`n_mels` frequencies evenly spaced on the mel scale between fmin/fmax."""
    min_mel = hz_to_mel(fmin, htk=htk)
    max_mel = hz_to_mel(fmax, htk=htk)
    mels = np.linspace(min_mel, max_mel, n_mels)
    return mel_to_hz(mels, htk=htk)


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    """Center frequencies of rFFT bins: linspace(0, sr/2, 1 + n_fft//2)."""
    return np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, endpoint=True)


def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_mels, 1 + n_fft//2)``.

    Matches librosa.filters.mel semantics: triangle ramps between adjacent mel
    break frequencies, optionally area-normalized (Slaney: 2 / bandwidth).
    """
    if fmax is None:
        fmax = sr / 2.0

    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk=htk)

    fdiff = np.diff(mel_f)
    ramps = mel_f.reshape(-1, 1) - fftfreqs.reshape(1, -1)

    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights = weights * enorm.reshape(-1, 1)
    elif norm is not None:
        raise ValueError(f"Unsupported norm={norm!r}")

    return weights.astype(dtype)


def hann_window(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic ("fftbins") Hann window, the STFT default."""
    k = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(dtype)


def dft_matrices(n_fft: int, window: np.ndarray | None = None, dtype=np.float32):
    """Real DFT as two matrices (Wc, Ws), shapes (n_fft, 1 + n_fft//2).

    ``frames @ Wc`` and ``frames @ Ws`` give the real and imaginary parts of
    ``rfft(frames * window)``: the window is folded into the matrices.
    """
    n_bins = 1 + n_fft // 2
    n = np.arange(n_fft, dtype=np.float64).reshape(-1, 1)
    k = np.arange(n_bins, dtype=np.float64).reshape(1, -1)
    ang = 2.0 * np.pi * n * k / n_fft
    wc = np.cos(ang)
    ws = -np.sin(ang)
    if window is not None:
        wc = wc * window.reshape(-1, 1).astype(np.float64)
        ws = ws * window.reshape(-1, 1).astype(np.float64)
    return wc.astype(dtype), ws.astype(dtype)
