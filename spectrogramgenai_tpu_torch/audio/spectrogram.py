"""Batched log-mel spectrogram (PyTorch) and its float64 NumPy oracle.

Counterpart of ``spectrogramgenai_tpu/audio/spectrogram.py``. The reference
wav→spec contract (reference src/helpers.py:83-92) is

    spec = melspectrogram(y, sr, n_mels=256, hop_length=384)   # n_fft=2048 (librosa default)
    spec = power_to_db(spec, ref=max)[:, :256]                 # top_db=80 clamp

Centre padding is zeros (``torch.stft`` would pad with reflect). The
per-sample ``ref=max`` dB conversion is taken over the full spectrogram and
only then is the time axis cropped to ``num_frames``.

:func:`logmel_spectrogram` is the plain tensor version (``torch.fft.rfft``);
the CLI's path is ``ops.mel_kernel.fused_logmel``, the hand-written kernel.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from spectrogramgenai_tpu_torch.audio import mel as melmath


@dataclasses.dataclass(frozen=True)
class SpectrogramConfig:
    """Static spectrogram parameters (hashable, so constants cache per config)."""

    sample_rate: int = 22050
    n_fft: int = 2048  # librosa default — the reference's `nfft=512` only sets the hop
    hop_length: int = 384  # int(0.75 * 512), reference src/helpers.py:90
    n_mels: int = 256
    num_frames: int = 256  # the reference's trailing `[:, :256]` crop
    fmin: float = 0.0
    fmax: float | None = None
    power: float = 2.0
    top_db: float = 80.0
    amin: float = 1e-10
    center: bool = True
    clip_seconds: float = 6.0

    @property
    def n_bins(self) -> int:
        return 1 + self.n_fft // 2

    @property
    def clip_samples(self) -> int:
        return int(self.clip_seconds * self.sample_rate)

    def frames_for(self, num_samples: int) -> int:
        padded = num_samples + (self.n_fft if self.center else 0)
        return 1 + (padded - self.n_fft) // self.hop_length


@functools.lru_cache(maxsize=16)
def constants(cfg: SpectrogramConfig) -> tuple[np.ndarray, np.ndarray]:
    """(Hann window (n_fft,), mel filterbank (n_mels, n_bins)), float32, once per config."""
    window = melmath.hann_window(cfg.n_fft)
    fb = melmath.mel_filterbank(sr=cfg.sample_rate, n_fft=cfg.n_fft, n_mels=cfg.n_mels,
                                fmin=cfg.fmin, fmax=cfg.fmax)
    return window, fb


def frame_signal(audio: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    """(B, N) → (B, T, n_fft) overlapping frames, centred with zero padding."""
    pad = cfg.n_fft // 2 if cfg.center else 0
    x = F.pad(audio, (pad, pad))
    return x.unfold(-1, cfg.n_fft, cfg.hop_length)


def stft_power(audio: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    """(B, N) → (B, T, n_bins) power spectrogram |STFT|^power, float32."""
    window, _ = constants(cfg)
    frames = frame_signal(audio.float(), cfg) * torch.from_numpy(window).to(audio.device)
    mag = torch.fft.rfft(frames, dim=-1).abs()
    if cfg.power == 2.0:
        return mag * mag
    return mag**cfg.power


def mel_power_spectrogram(audio: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    """(B, N) → (B, n_mels, T) mel power spectrogram."""
    _, fb = constants(cfg)
    power = stft_power(audio, cfg)  # (B, T, F)
    return torch.einsum("btf,mf->bmt", power, torch.from_numpy(fb).to(power.device))


def power_to_db(s: torch.Tensor, amin: float = 1e-10, top_db: float | None = 80.0,
                ref: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sample ``power_to_db(S, ref=max)`` over the trailing (mel, time) axes:
    dB relative to each sample's own max, clamped to ``[peak - top_db, …]``."""
    reduce_axes = tuple(range(1, s.dim()))
    if ref is None:
        ref = s.amax(dim=reduce_axes, keepdim=True)
    log_spec = 10.0 * torch.log10(s.clamp(min=amin))
    log_spec = log_spec - 10.0 * torch.log10(ref.clamp(min=amin))
    if top_db is not None:
        peak = log_spec.amax(dim=reduce_axes, keepdim=True)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


def logmel_spectrogram(audio: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    """(B, N) audio → (B, n_mels, num_frames) log-mel in dB: dB over the full
    spectrogram, then the crop to ``cfg.num_frames``."""
    db = power_to_db(mel_power_spectrogram(audio, cfg), amin=cfg.amin, top_db=cfg.top_db)
    return db[..., : cfg.num_frames]


# ---------------------------------------------------------------------------
# NumPy oracle (float64), the reference the tests and chip_smoke.py hold
# every path to.
# ---------------------------------------------------------------------------


def reference_logmel_np(audio: np.ndarray, cfg: SpectrogramConfig) -> np.ndarray:
    """Single-clip (N,) → (n_mels, ≤num_frames) log-mel, pure NumPy."""
    window, fb = constants(cfg)
    pad = cfg.n_fft // 2 if cfg.center else 0
    x = np.pad(audio.astype(np.float64), (pad, pad))
    n_frames = 1 + (len(x) - cfg.n_fft) // cfg.hop_length
    frames = np.stack([x[i * cfg.hop_length : i * cfg.hop_length + cfg.n_fft] for i in range(n_frames)])
    spec = np.fft.rfft(frames * window.astype(np.float64), axis=-1)
    power = np.abs(spec) ** cfg.power
    mel = fb.astype(np.float64) @ power.T  # (n_mels, T)

    # Reference order (helpers.py:92): dB over the full spectrogram, THEN crop.
    ref = mel.max()
    log_spec = 10.0 * np.log10(np.maximum(cfg.amin, mel))
    log_spec -= 10.0 * np.log10(np.maximum(cfg.amin, ref))
    if cfg.top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - cfg.top_db)
    return log_spec[:, : cfg.num_frames].astype(np.float32)
