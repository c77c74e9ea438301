"""Spectrogram → audio inversion: mel NNLS inverse and momentum Griffin-Lim (PyTorch).

Counterpart of ``spectrogramgenai_tpu/audio/invert.py``. Reconstructs
peak-normalised waveforms from dB mel spectrograms (.npy arrays, or the
uint8 read-back of a generated PNG) on the device the input lies on:

  * mel power → linear power: FISTA for min_{S≥0} ‖fb·S − mel‖², one
    (n_bins × n_bins)·(n_bins × T) product an iteration, float32 at full
    precision (TF32 off whatever the caller set, as JAX asks for HIGHEST);
  * linear magnitude → waveform: fast Griffin-Lim (the momentum form of
    librosa.griffinlim), one ISTFT and one STFT an iteration;
  * dB → power: the inverse of ``power_to_db(ref=max)`` up to the lost
    per-sample level, so each output row is normalised to its own peak.

Everything runs in float32 (complex64), or in float64 (complex128) for a
float64 input with the constants cast up: the card's checks hold the float32
chain to it. Framing pads with zeros (``torch.stft`` would reflect-pad), and
the overlap-add is ``span`` slice-adds (``index_add_``'s float atomics are
not deterministic on CUDA). Every row is computed on its own: nothing mixes
the rows of a batch. Random initial phase is an injected tensor, since the
two packages' random streams differ.
"""

from __future__ import annotations

import functools
import io

import numpy as np
import torch
import torch.nn.functional as F

from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig, constants, frame_signal
from spectrogramgenai_tpu_torch.core.precision import full_float32


@functools.lru_cache(maxsize=32)
def _window(cfg: SpectrogramConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(constants(cfg)[0]).to(device)


def _real(x: torch.Tensor) -> torch.Tensor:
    """float64 stays; anything else becomes float32."""
    return x if x.dtype == torch.float64 else x.float()


def stft_complex(audio: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    """(B, N) → (B, T, n_bins) complex STFT (Hann window, centred, zero padding)."""
    audio = _real(audio)
    frames = frame_signal(audio, cfg) * _window(cfg, audio.device).to(audio.dtype)
    return torch.fft.rfft(frames, dim=-1)


def _overlap_add(frames: torch.Tensor, hop: int, total: int) -> torch.Tensor:
    """(B, T, n_fft) windowed frames → (B, total) overlap-add: each frame split
    into ``span = ceil(n_fft/hop)`` hop-sized pieces, piece j of frame f lands
    on output row f + j, so the sum is ``span`` slice-adds in the order j."""
    b, t, n_fft = frames.shape
    span = -(-n_fft // hop)
    pieces = F.pad(frames, (0, span * hop - n_fft)).reshape(b, t, span, hop)
    rows = frames.new_zeros(b, t + span, hop)
    for j in range(span):
        rows[:, j : j + t] += pieces[:, :, j]
    return rows.reshape(b, (t + span) * hop)[:, :total]


@functools.lru_cache(maxsize=64)
def _nola_inv(cfg: SpectrogramConfig, t: int) -> np.ndarray:
    """1 / (summed squared window) of a t-frame ISTFT, float64 on the host, cast to float32."""
    window, _ = constants(cfg)
    hop = cfg.hop_length
    total = (t - 1) * hop + cfg.n_fft
    norm = np.zeros(total, np.float64)
    wsq = window.astype(np.float64) ** 2
    for f in range(t):
        norm[f * hop : f * hop + cfg.n_fft] += wsq
    return (1.0 / np.maximum(norm, 1e-10)).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _nola_inv_on(cfg: SpectrogramConfig, t: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_nola_inv(cfg, t)).to(device)


def istft(stft_c: torch.Tensor, cfg: SpectrogramConfig, length: int | None = None) -> torch.Tensor:
    """(B, T, n_bins) complex → (B, length) inverse STFT (librosa.istft
    semantics): the synthesis-windowed overlap-add over the summed squared
    window, the centre padding trimmed. ``length`` defaults to (T − 1)·hop
    for centred input; past the reconstructable span the output is zero."""
    b, t, _ = stft_c.shape
    frames = torch.fft.irfft(stft_c, n=cfg.n_fft, dim=-1)
    frames = frames * _window(cfg, stft_c.device).to(frames.dtype)
    total = (t - 1) * cfg.hop_length + cfg.n_fft
    out = _overlap_add(frames, cfg.hop_length, total) * _nola_inv_on(cfg, t, stft_c.device).to(frames.dtype)
    pad = cfg.n_fft // 2 if cfg.center else 0
    if length is None:
        length = (t - 1) * cfg.hop_length if cfg.center else total
    if pad + length > total:  # zero-pad, where a clamped start would shift the signal
        out = F.pad(out, (0, pad + length - total))
    return out[:, pad : pad + length]


def griffin_lim(mag: torch.Tensor, cfg: SpectrogramConfig, n_iter: int = 32, momentum: float = 0.99,
                length: int | None = None, phase: torch.Tensor | None = None) -> torch.Tensor:
    """Fast Griffin-Lim: (B, T, n_bins) magnitude → (B, length) waveform.

    Each iteration rebuilds the STFT of the current estimate and takes
    ``rebuilt − momentum/(1 + momentum)·previous`` at unit modulus. The
    initial phase is all ones, or ``exp(i·phase)`` for an injected ``phase``
    (radians, the magnitude's shape). The iterations run at the full span of
    the T frames; ``length`` applies to the last synthesis only."""
    mag = _real(mag)
    cdtype = torch.complex128 if mag.dtype == torch.float64 else torch.complex64
    if phase is None:
        angles = torch.ones_like(mag, dtype=cdtype)
    else:
        angles = torch.exp(1j * phase.to(mag.device, cdtype))
    t = mag.shape[1]
    span = (t - 1) * cfg.hop_length if cfg.center else (t - 1) * cfg.hop_length + cfg.n_fft
    alpha = momentum / (1.0 + momentum)
    tprev = torch.zeros_like(angles)
    for _ in range(n_iter):
        rebuilt = stft_complex(istft(mag * angles, cfg, length=span), cfg)[:, :t, :]
        new = rebuilt - alpha * tprev
        angles, tprev = new / new.abs().clamp(min=1e-16), rebuilt
    return istft(mag * angles, cfg, length=length if length is not None else span)


@functools.lru_cache(maxsize=16)
def _nnls_constants(cfg: SpectrogramConfig) -> tuple[np.ndarray, float]:
    """(gram = fbᵀfb as float32, its largest eigenvalue, the Lipschitz constant, from float64)."""
    _, fb = constants(cfg)
    gram = (fb.T @ fb).astype(np.float64)
    lip = float(np.linalg.eigvalsh(gram).max())
    return gram.astype(np.float32), lip


@functools.lru_cache(maxsize=16)
def _nnls_on(cfg: SpectrogramConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, float]:
    gram, lip = _nnls_constants(cfg)
    return torch.from_numpy(constants(cfg)[1]).to(device), torch.from_numpy(gram).to(device), lip


@functools.lru_cache(maxsize=16)
def _fista_betas(n_iter: int) -> tuple[float, ...]:
    """FISTA's momentum weights (t_k − 1)/t_{k+1}, t_{k+1} = (1 + √(1 + 4t_k²))/2,
    in float64 on the host, rounded to float32."""
    tks = np.ones(n_iter + 1)
    for k in range(n_iter):
        tks[k + 1] = (1.0 + np.sqrt(1.0 + 4.0 * tks[k] ** 2)) / 2.0
    return tuple(float(b) for b in ((tks[:-1] - 1.0) / tks[1:]).astype(np.float32))


def mel_power_to_stft_power(mel: torch.Tensor, cfg: SpectrogramConfig, n_iter: int = 32) -> torch.Tensor:
    """(B, n_mels, T) mel power → (B, T, n_bins) linear power: ``n_iter``
    FISTA steps of projected accelerated gradient on min_{S≥0} ‖fb·S − mel‖²
    (the problem librosa.feature.inverse.mel_to_stft gives scipy's nnls)."""
    mel = _real(mel)
    fb, gram, lip = _nnls_on(cfg, mel.device)
    fb, gram = fb.to(mel.dtype), gram.to(mel.dtype)
    with full_float32():
        num = torch.einsum("mf,bmt->bft", fb, mel)
        s = y = (num / lip).clamp(min=0.0)
        for beta in _fista_betas(n_iter):
            grad = torch.einsum("fg,bgt->bft", gram, y) - num
            s_new = (y - grad / lip).clamp(min=0.0)
            y = s_new + beta * (s_new - s)
            s = s_new
    return s.transpose(1, 2)


def resample_wavs(wavs, sr: int, out_sr: int | None) -> tuple[list[np.ndarray], int]:
    """Polyphase-resample a list or array of waveforms; no-op when the rates match."""
    if not out_sr or out_sr == sr:
        return list(wavs), sr
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(int(out_sr), int(sr))
    return [resample_poly(np.asarray(w), out_sr // g, sr // g).astype(np.float32) for w in wavs], int(out_sr)


def db_to_power(db: torch.Tensor) -> torch.Tensor:
    """Inverse of power_to_db up to the lost per-sample ``ref=max`` scale:
    relative power in (0, 1], peak at 1."""
    return torch.pow(10.0, db / 10.0)


def png_unit_to_db(img01, top_db: float = 80.0):
    """uint8/255 grayscale read-back → dB, assuming the stored image spanned
    the full ``[peak − top_db, peak]`` clamp range."""
    return img01 * top_db - top_db


def _call(fn):
    return fn()


def db_mel_to_audio(db: torch.Tensor, cfg: SpectrogramConfig, gl_iters: int = 32, nnls_iters: int = 32,
                    phase: torch.Tensor | None = None, timers=(_call, _call)) -> torch.Tensor:
    """(B, n_mels, T) dB mel spectrogram → (B, (T − 1)·hop) peak-normalised
    audio: dB → mel power → NNLS linear power → magnitude → Griffin-Lim.
    ``timers`` (two callables that run a function, e.g. ``cli.common.DeviceTimer``)
    wrap the NNLS and the Griffin-Lim stage."""
    nnls_timer, gl_timer = timers
    stft_pow = nnls_timer(lambda: mel_power_to_stft_power(db_to_power(_real(db)), cfg, n_iter=nnls_iters))
    stft_pow = stft_pow.clamp(min=0.0)
    mag = stft_pow.sqrt() if cfg.power == 2.0 else stft_pow.pow(1.0 / cfg.power)
    wav = gl_timer(lambda: griffin_lim(mag, cfg, n_iter=gl_iters, phase=phase))
    peak = wav.abs().amax(dim=1, keepdim=True)
    return wav / peak.clamp(min=1e-10)


def wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    """One float waveform in [-1, 1] → a 16-bit PCM WAV file's bytes."""
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16))
    return buf.getvalue()


class AudioReconstructor:
    """Generated uint8 spectrograms → waveforms or WAV bytes, inverted on ``device``.

    Wraps :func:`db_mel_to_audio` for serving and the generate CLI. The JAX
    class pads a batch to a power of two to bound its jit cache; here each
    batch runs at its own size, and a row's output does not depend on the
    batch it came in.
    """

    def __init__(self, sample_rate: int = 22050, n_fft: int = 2048, hop_length: int = 384, gl_iters: int = 32,
                 nnls_iters: int = 32, top_db: float = 80.0, out_sr: int | None = None,
                 device: torch.device | str = "cuda"):
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.gl_iters = gl_iters
        self.nnls_iters = nnls_iters
        self.top_db = top_db
        self.out_sr = out_sr
        self.device = torch.device(device)

    def _cfg(self, n_mels: int, n_frames: int) -> SpectrogramConfig:
        return SpectrogramConfig(sample_rate=self.sample_rate, n_fft=self.n_fft, hop_length=self.hop_length,
                                 n_mels=n_mels, num_frames=n_frames)

    def waveforms(self, imgs: np.ndarray) -> tuple[list[np.ndarray], int]:
        """[n, H, W(, 1)] uint8 spectrograms → (n float32 waveforms, sample rate)."""
        imgs = np.asarray(imgs)
        if imgs.ndim == 4 and imgs.shape[-1] == 1:
            imgs = imgs[..., 0]
        _, h, w = imgs.shape
        db = torch.from_numpy(imgs.astype(np.float32) / 255.0 * self.top_db - self.top_db).to(self.device)
        wavs = db_mel_to_audio(db, self._cfg(h, w), gl_iters=self.gl_iters, nnls_iters=self.nnls_iters)
        return resample_wavs(wavs.cpu().numpy(), self.sample_rate, self.out_sr)

    def wav_bytes_batch(self, imgs: np.ndarray) -> list[bytes]:
        """[n, H, W(, 1)] uint8 spectrograms → n WAV (16-bit PCM) byte strings."""
        wavs, sr = self.waveforms(imgs)
        return [wav_bytes(wv, sr) for wv in wavs]

    @property
    def output_sample_rate(self) -> int:
        return self.out_sr or self.sample_rate

    def warmup(self, n_mels: int, n_frames: int, counts=(1,)) -> None:
        """One inversion per count at the given image geometry (cuFFT plans, the allocator)."""
        for c in counts:
            self.wav_bytes_batch(np.zeros((c, n_mels, n_frames), np.uint8))
