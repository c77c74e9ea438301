"""Noise/bird mixing for the source separator (``spectrogramgenai_tpu/audio/mix.py``).

Mixes a noise recording and a bird recording with ε ~ U(0, 0.3):
``mix = ε·noise + (1 − ε)·bird``, rescales each waveform to [-1, 1] by its
min and max, computes the three log-mel spectrograms, and applies the
reference's midpoint normalisation ``(s − m)/m``, negated where m < 0.

The waveforms are assembled on the host in NumPy with the JAX module's
types: ε is float64, so the mix and its rescale are computed in float64 and
rounded to float32 once, where the noise and bird rows are rescaled in
float32. The three spectrograms go through ``ops/mel_kernel.fused_logmel``
at the exact rung by default: on a CUDA device that launches the exact mel
kernel (``mel_power_fft_kernel``) or raises, on the CPU it computes the
kernel's plain version. There is no other path.
"""

from __future__ import annotations

import numpy as np
import torch

from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig
from spectrogramgenai_tpu_torch.ops.mel_kernel import fused_logmel


def rescale_wav(x: np.ndarray) -> np.ndarray:
    """min/max → [-1, 1]."""
    x = (x - x.min()) / (x.max() - x.min())
    return 2.0 * (x - 0.5)


def mix_waveforms(noise: np.ndarray, bird: np.ndarray, eps: float):
    mix = eps * noise + (1.0 - eps) * bird
    return rescale_wav(noise), rescale_wav(bird), rescale_wav(mix)


def midpoint_normalize(spec: np.ndarray) -> np.ndarray:
    """(s − m)/m with m = (min + max)/2, negated when m < 0."""
    m = (spec.min() + spec.max()) / 2.0
    out = (spec - m) / m
    return -out if m < 0 else out


def midpoint_normalize_batch(specs: torch.Tensor) -> torch.Tensor:
    """:func:`midpoint_normalize` of each (n_mels, frames) sample of ``specs``, on its device."""
    m = (specs.amin(dim=(1, 2), keepdim=True) + specs.amax(dim=(1, 2), keepdim=True)) / 2.0
    out = (specs - m) / m
    return torch.where(m < 0, -out, out)


def rescale_batch(x: np.ndarray) -> np.ndarray:
    mn = x.min(axis=1, keepdims=True)
    mx = x.max(axis=1, keepdims=True)
    y = (x - mn) / (mx - mn)
    return 2.0 * (y - 0.5)


def mix_stack(noise_wavs: np.ndarray, bird_wavs: np.ndarray, eps: np.ndarray) -> np.ndarray:
    """(B, N) noise and bird float32 + (B,) float64 ε → (3B, N) float32: the
    rescaled noise rows, bird rows and mix rows, in that order."""
    eps = np.asarray(eps, np.float64)
    mix = eps[:, None] * noise_wavs + (1.0 - eps[:, None]) * bird_wavs
    stacked = np.concatenate([rescale_batch(noise_wavs), rescale_batch(bird_wavs), rescale_batch(mix)], axis=0)
    return stacked.astype(np.float32)


def mix_batch_specs(noise_wavs: np.ndarray, bird_wavs: np.ndarray, eps: np.ndarray, cfg: SpectrogramConfig,
                    device: torch.device | str = "cuda", exact=True, timers=None):
    """(B, N) + (B, N) + (B,) ε → three (B, n_mels, num_frames) midpoint-normalised
    float32 spectrograms (noise, bird, mix) on ``device``. ``timers`` (a dict
    of ``cli.common.DeviceTimer``s under "kernel" and "normalise"), where
    given, time the log-mel and the normalisation."""
    audio = torch.from_numpy(mix_stack(noise_wavs, bird_wavs, eps)).to(device)

    def timed(name, fn):
        return timers[name](fn) if timers else fn()

    specs = timed("kernel", lambda: fused_logmel(audio, cfg, exact=exact))
    out = timed("normalise", lambda: midpoint_normalize_batch(specs))
    return tuple(out.chunk(3))
