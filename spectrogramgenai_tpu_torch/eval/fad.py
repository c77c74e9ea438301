"""Fréchet Audio Distance (``spectrogramgenai_tpu/eval/fad.py``).

Scores a background audio directory against an evaluation one by the
Fréchet distance of their clip embeddings (``eval.inception.frechet_distance``,
clamped at 0). The embeddings:

  * ``mel`` mode: [mean over time, std over time] of each clip's 256-mel
    log spectrogram at ``SpectrogramConfig(sample_rate=sr)`` (512-d), the
    clips cut to the shortest: a framework-native embedding for relative
    comparisons, not comparable to published CLAP-FAD numbers;
  * ``clap`` mode: the CLAP audio tower (``eval/clap.py``) with converted
    weights (``tools/port_convert_clap.py``), the reference's embedder, at 48 kHz;
  * precomputed embeddings (``.npy`` per clip, or one ``.npz`` / ``.npy`` matrix).

Both modes' log-mel runs on the exact mel kernel (``fused_mel_power``,
``exact=True``): on a CUDA device it launches ``mel_power_fft_kernel`` or
raises, on the CPU it is the kernel's plain version.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from spectrogramgenai_tpu_torch.eval.inception import frechet_distance, gaussian_statistics

FAD_SAMPLE_RATE = 48000


def mel_statistics_embeddings(wavs: list[np.ndarray], sr: int, batch: int = 32,
                              device: torch.device | str = "cuda") -> np.ndarray:
    """(n, 512) float32: [mean_t, std_t] (population std) of the 256-mel log
    spectrogram (dB, ref = each clip's max, top_db 80, cropped to 256 frames)
    of each clip cut to the shortest clip's length."""
    from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig
    from spectrogramgenai_tpu_torch.ops.mel_kernel import fused_logmel

    cfg = SpectrogramConfig(sample_rate=sr)
    n = min(len(w) for w in wavs)
    stack = np.stack([w[:n] for w in wavs]).astype(np.float32)
    out = []
    for i in range(0, len(stack), batch):
        spec = fused_logmel(torch.from_numpy(stack[i : i + batch]).to(device), cfg, exact=True).double()
        out.append(torch.cat([spec.mean(dim=2), spec.std(dim=2, correction=0)], dim=1).float().cpu().numpy())
    return np.concatenate(out, axis=0)


def load_embeddings(path: str) -> np.ndarray:
    """A directory of per-clip .npy files (sorted by name), or one .npz (its first array) or .npy matrix."""
    if os.path.isdir(path):
        files = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
        return np.stack([np.load(os.path.join(path, f)) for f in files])
    if path.endswith(".npz"):
        data = np.load(path)
        return data[list(data.keys())[0]]
    return np.load(path)


def load_audio_dir(audio_dir: str, target_sr: int) -> list[np.ndarray]:
    """Every .wav of ``audio_dir`` (sorted by name) as mono float32 at ``target_sr``."""
    from spectrogramgenai_tpu_torch.audio.wavio import load_wav

    wavs = [load_wav(os.path.join(audio_dir, f), target_sr=target_sr)[0]
            for f in sorted(os.listdir(audio_dir)) if f.lower().endswith(".wav")]
    if not wavs:
        raise FileNotFoundError(f"no wav files in {audio_dir}")
    return wavs


def embeddings_for_dir(audio_dir: str, mode: str = "mel", target_sr: int = FAD_SAMPLE_RATE,
                       clap_ckpt: str | None = None, device: torch.device | str = "cuda") -> np.ndarray:
    """The ``mode`` embeddings of every .wav of ``audio_dir``, resampled to ``target_sr`` on load."""
    wavs = load_audio_dir(audio_dir, target_sr)
    if mode == "mel":
        return mel_statistics_embeddings(wavs, target_sr, device=device)
    if mode == "clap":
        from spectrogramgenai_tpu_torch.eval.clap import clap_embeddings, load_clap_params

        if not clap_ckpt:
            raise ValueError("clap mode needs --clap_ckpt (converted via tools/port_convert_clap.py)")
        if target_sr != FAD_SAMPLE_RATE:
            # the CLAP front end is fixed at 48 kHz: any other rate would misscale the clips
            raise ValueError(f"clap mode requires sample_rate={FAD_SAMPLE_RATE} "
                             f"(got {target_sr}); wavs are resampled on load")
        return clap_embeddings(wavs, load_clap_params(clap_ckpt), device=device)
    raise ValueError(f"unknown embedding mode {mode!r}")


def fad_score(background: np.ndarray, evaluation: np.ndarray) -> float:
    """Fréchet distance between the two embedding sets, clamped at 0 (sqrtm
    can give a tiny negative for near-identical sets)."""
    mu_b, s_b = gaussian_statistics(background)
    mu_e, s_e = gaussian_statistics(evaluation)
    return max(0.0, frechet_distance(mu_b, s_b, mu_e, s_e))
