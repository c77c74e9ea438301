"""The CLAP audio tower (HTSAT Swin transformer), the reference's FAD embedder.

Counterpart of ``spectrogramgenai_tpu/eval/clap.py``: laion-clap's unfused
"630k-audioset" audio encoder (HTSAT-tiny + a two-layer projection), with
the JAX module's parameter names, so ``tools/convert_clap.py``'s
``clap_audio.msgpack`` loads through ``bridge.state_dict_from_flax``:

  wav (48 kHz) → int16 round trip → repeatpad to 10 s → log-mel (1024-point
  STFT, hop 480, 64 Slaney mels up to 14 kHz, 10·log10) → BatchNorm over the
  mel bins → bicubic time resize to 1024 frames (align_corners) → the four
  time chunks stacked along frequency into 256×256 → 4×4 patch embed →
  Swin stages (depths 2, 2, 6, 2; heads 4, 8, 16, 32; window 8, shifted) →
  LayerNorm → token mean → Linear → ReLU → Linear → 512-d embedding.

Unlike the port's other modules: LayerNorm eps is 1e-5 (flax's default is
1e-6), GELU is exact (erf, not tanh), and :func:`quantize_int16` truncates
toward zero. The log-mel's power spectrogram is the exact mel kernel
(``ops.mel_kernel.fused_mel_power``, ``exact=True``) on the reflect-padded
clip with centring off: on a CUDA tensor it launches
``mel_power_fft_kernel`` or raises; on a CPU tensor it is the kernel's plain
version. The window attention (a relative-position bias and the shifted
windows' mask) runs as float32 ``torch.matmul``s, as the JAX module's
einsums do. Forwards run in float32 with TF32 off. Inference only.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig
from spectrogramgenai_tpu_torch.models.classifiers import BatchNorm

CLAP_SAMPLE_RATE = 48000


@dataclasses.dataclass(frozen=True)
class ClapAudioTowerConfig:
    """transformers' ``ClapAudioConfig`` (the unfused fields)."""

    num_mel_bins: int = 64
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: int = 4
    patch_embeds_hidden_size: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_attention_heads: tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-5
    projection_dim: int = 512
    # the mel front end (ClapFeatureExtractor's defaults at 48 kHz)
    sampling_rate: int = CLAP_SAMPLE_RATE
    fft_window_size: int = 1024
    hop_length: int = 480
    max_length_s: int = 10
    frequency_min: float = 0.0
    frequency_max: float = 14000.0

    @property
    def hidden_size(self) -> int:  # the last Swin stage's width
        return self.patch_embeds_hidden_size * 2 ** (len(self.depths) - 1)

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.num_mel_bins


# ---------------------------------------------------------------------------
# The mel front end (ClapFeatureExtractor's repeatpad path)
# ---------------------------------------------------------------------------


def quantize_int16(wav: np.ndarray) -> np.ndarray:
    """float32 → int16 (truncating toward zero) → float32, as
    frechet_audio_distance feeds CLAP."""
    as_int = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    return (as_int / 32767.0).astype(np.float32)


def repeatpad(wav: np.ndarray, max_samples: int) -> np.ndarray:
    """Whole copies of a short clip, then zeros up to ``max_samples``; a
    longer clip is cut to its first ``max_samples`` (the JAX module's
    deterministic head crop)."""
    if len(wav) >= max_samples:
        return wav[:max_samples]
    n_repeat = max(1, int(max_samples / len(wav)))
    wav = np.tile(wav, n_repeat)
    return np.pad(wav, (0, max_samples - len(wav)))


def spectrogram_config(cfg: ClapAudioTowerConfig) -> SpectrogramConfig:
    """The mel kernel's configuration of the CLAP front end: periodic Hann,
    Slaney mels, power 2, no centring (the caller reflect-pads)."""
    return SpectrogramConfig(sample_rate=cfg.sampling_rate, n_fft=cfg.fft_window_size, hop_length=cfg.hop_length,
                             n_mels=cfg.num_mel_bins, fmin=cfg.frequency_min, fmax=cfg.frequency_max, center=False)


def clap_logmel(waveform: torch.Tensor, cfg: ClapAudioTowerConfig = ClapAudioTowerConfig()) -> torch.Tensor:
    """(B, N) float32 → (B, 1 + N // hop, n_mels) log-mel: reflect pad by
    n_fft / 2, the exact mel kernel's power, 10·log10(max(mel, 1e-10))
    (reference 1, no top_db)."""
    from spectrogramgenai_tpu_torch.ops.mel_kernel import fused_mel_power

    pad = cfg.fft_window_size // 2
    x = F.pad(waveform.float(), (pad, pad), mode="reflect").contiguous()
    mel = fused_mel_power(x, spectrogram_config(cfg), exact=True)
    return 10.0 * torch.log10(mel.clamp(min=1e-10))


def clap_input_features(wavs: list[np.ndarray], cfg: ClapAudioTowerConfig = ClapAudioTowerConfig(),
                        device: torch.device | str = "cuda") -> torch.Tensor:
    """Clips (float arrays at 48 kHz) → (B, 1, n_frames, n_mels) model input on ``device``."""
    max_samples = cfg.max_length_s * cfg.sampling_rate
    batch = np.stack([repeatpad(quantize_int16(np.asarray(w, np.float32)), max_samples) for w in wavs])
    return clap_logmel(torch.from_numpy(batch).to(device), cfg)[:, None]


# ---------------------------------------------------------------------------
# torch's bicubic interpolation (align_corners=True) as a matrix
# ---------------------------------------------------------------------------


def _cubic_weight(t: float, a: float = -0.75) -> float:
    t = abs(t)
    if t <= 1.0:
        return (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0
    if t < 2.0:
        return a * t**3 - 5.0 * a * t**2 + 8.0 * a * t - 4.0 * a
    return 0.0


def bicubic_align_corners_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 matrix of ``F.interpolate(mode="bicubic",
    align_corners=True)`` along one axis, border taps clamped."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1 or n_out == 1:
        m[:, 0] = 1.0
        return m
    for i in range(n_out):
        src = i * (n_in - 1) / (n_out - 1)
        f = math.floor(src)
        t = src - f
        for k in range(-1, 3):
            m[i, min(max(f + k, 0), n_in - 1)] += _cubic_weight(k - t)
    return m


@functools.lru_cache(maxsize=8)
def _bicubic(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(bicubic_align_corners_matrix(n_in, n_out)).to(device)


# ---------------------------------------------------------------------------
# Swin blocks
# ---------------------------------------------------------------------------


def _relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # (ws², ws²)


def _shift_attn_mask(height: int, width: int, ws: int, shift: int) -> np.ndarray:
    """(num_windows, ws², ws²) additive mask: -100 between tokens of different shifted regions."""
    img = np.zeros((height, width))
    count = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wslice in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wslice] = count
            count += 1
    windows = img.reshape(height // ws, ws, width // ws, ws).transpose(0, 2, 1, 3)
    windows = windows.reshape(-1, ws * ws)
    mask = windows[:, None, :] - windows[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws², C), windows in row-major order within each image."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    c = windows.shape[-1]
    x = windows.reshape(-1, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w, c)


class WindowAttention(nn.Module):
    """softmax(q·kᵀ/√d + relative-position bias [+ shift mask])·v over each window."""

    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("rel_index", torch.from_numpy(_relative_position_index(window_size).reshape(-1)),
                             persistent=False)
        self.query = nn.Linear(dim, dim, bias=qkv_bias)
        self.key = nn.Linear(dim, dim, bias=qkv_bias)
        self.value = nn.Linear(dim, dim, bias=qkv_bias)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """x (nW·B, ws², C); mask (nW, ws², ws²) additive, or None."""
        nwb, n, c = x.shape
        heads = self.num_heads
        hd = c // heads
        bias = self.relative_position_bias_table[self.rel_index].reshape(n, n, heads).permute(2, 0, 1)

        def head_split(layer: nn.Linear) -> torch.Tensor:
            return layer(x).reshape(nwb, n, heads, hd).transpose(1, 2)

        q, k, v = head_split(self.query), head_split(self.key), head_split(self.value)
        scores = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(hd) + bias
        if mask is not None:
            nw = mask.shape[0]
            scores = (scores.reshape(nwb // nw, nw, heads, n, n) + mask[None, :, None]).reshape(nwb, heads, n, n)
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
        return self.out(ctx.transpose(1, 2).reshape(nwb, n, c))


class SwinBlock(nn.Module):
    """(Shifted) window attention and an MLP, each pre-norm with a residual.
    A grid no larger than the window is one window, unshifted (transformers'
    ``set_shift_and_window_size``)."""

    def __init__(self, dim: int, num_heads: int, resolution: tuple[int, int], window_size: int, shift_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, eps: float = 1e-5):
        super().__init__()
        h, w = resolution
        if min(h, w) <= window_size:
            window_size, shift_size = min(h, w), 0
        if h % window_size or w % window_size:
            raise ValueError(f"grid {h}×{w} is not a whole number of {window_size}-windows")
        self.resolution, self.window_size, self.shift_size = resolution, window_size, shift_size
        self.layernorm_before = nn.LayerNorm(dim, eps=eps)
        self.attention = WindowAttention(dim, num_heads, window_size, qkv_bias)
        self.layernorm_after = nn.LayerNorm(dim, eps=eps)
        self.intermediate = nn.Linear(dim, int(mlp_ratio * dim))
        self.output = nn.Linear(int(mlp_ratio * dim), dim)
        mask = torch.from_numpy(_shift_attn_mask(h, w, window_size, shift_size)) if shift_size else None
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (h, w), ws, shift = self.resolution, self.window_size, self.shift_size
        b, n, c = x.shape
        y = self.layernorm_before(x).reshape(b, h, w, c)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = _window_reverse(self.attention(_window_partition(y, ws), self.attn_mask), ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y.reshape(b, n, c)
        return x + self.output(F.gelu(self.intermediate(self.layernorm_after(x))))


class PatchMerging(nn.Module):
    """2×2 neighbours concatenated ([0::2, 0::2], [1::2, 0::2], [0::2, 1::2],
    [1::2, 1::2]) → LayerNorm → Linear (no bias) to twice the width."""

    def __init__(self, dim: int, resolution: tuple[int, int], eps: float = 1e-5):
        super().__init__()
        self.resolution = resolution
        self.norm = nn.LayerNorm(4 * dim, eps=eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.resolution
        b, _, c = x.shape
        y = x.reshape(b, h, w, c)
        y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2], y[:, 0::2, 1::2], y[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(y.reshape(b, (h // 2) * (w // 2), 4 * c)))


class ClapAudioTower(nn.Module):
    """HTSAT audio encoder and projection: (B, 1, n_frames, n_mels) log-mel
    (transformers' ``ClapAudioModel`` layout) → (B, projection_dim)
    embeddings, not L2-normalised."""

    def __init__(self, cfg: ClapAudioTowerConfig = ClapAudioTowerConfig()):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.patch_embeds_hidden_size
        self.batch_norm = BatchNorm(cfg.num_mel_bins, eps=1e-5)
        self.patch_embed_proj = nn.Conv2d(1, hidden, cfg.patch_size, stride=cfg.patch_stride)
        self.patch_embed_norm = nn.LayerNorm(hidden, eps=cfg.layer_norm_eps)
        grid = (cfg.spec_size - cfg.patch_size) // cfg.patch_stride + 1
        res, dim = (grid, grid), hidden
        for i, depth in enumerate(cfg.depths):
            for j in range(depth):
                setattr(self, f"layers_{i}_blocks_{j}", SwinBlock(
                    dim, cfg.num_attention_heads[i], res, cfg.window_size,
                    0 if j % 2 == 0 else cfg.window_size // 2, cfg.mlp_ratio, cfg.qkv_bias, cfg.layer_norm_eps))
            if i < len(cfg.depths) - 1:
                setattr(self, f"layers_{i}_downsample", PatchMerging(dim, res, cfg.layer_norm_eps))
                res, dim = (res[0] // 2, res[1] // 2), dim * 2
        self.norm = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.linear1 = nn.Linear(dim, cfg.projection_dim)
        self.linear2 = nn.Linear(cfg.projection_dim, cfg.projection_dim)

    def forward(self, input_features: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, ch, t, f = input_features.shape
        if ch != 1 or f != cfg.num_mel_bins:
            raise ValueError(f"input must be (B, 1, T, {cfg.num_mel_bins}), got {tuple(input_features.shape)}")
        # BatchNorm over the mel bins, with the running statistics
        x = self.batch_norm(input_features[:, 0].float().transpose(1, 2)[..., None], train=False)[..., 0]
        x = x.transpose(1, 2)  # (B, T, F)

        # mel → image: bicubic time resize to spec_width, then the freq_ratio
        # time chunks stacked along frequency → (spec_size, spec_size)
        spec_width, spec_height = cfg.spec_size * cfg.freq_ratio, cfg.spec_size // cfg.freq_ratio
        if t > spec_width or f > spec_height:
            raise ValueError(f"{t} frames × {f} mels exceed the {spec_width} × {spec_height} image")
        if t < spec_width:
            x = torch.matmul(_bicubic(t, spec_width, x.device), x)
        if f < spec_height:
            x = torch.matmul(x, _bicubic(f, spec_height, x.device).T)
        x = x.reshape(b, cfg.freq_ratio, cfg.spec_size, spec_height).transpose(2, 3)
        x = x.reshape(b, 1, cfg.freq_ratio * spec_height, cfg.spec_size)

        # patch embed; tokens in (H, W) row-major order
        x = self.patch_embed_proj(x)
        x = self.patch_embed_norm(x.flatten(2).transpose(1, 2))
        for i, depth in enumerate(cfg.depths):
            for j in range(depth):
                x = getattr(self, f"layers_{i}_blocks_{j}")(x)
            if i < len(cfg.depths) - 1:
                x = getattr(self, f"layers_{i}_downsample")(x)
        # transformers pools a freq-grouped map over all positions: the token mean
        latent = self.norm(x).mean(dim=1)
        return self.linear2(F.relu(self.linear1(latent)))


# ---------------------------------------------------------------------------
# Embeddings (FAD's "clap" mode)
# ---------------------------------------------------------------------------


def load_clap_params(ckpt_path: str) -> dict:
    """The flax variables of a converted CLAP checkpoint (``tools/port_convert_clap.py``), as nested NumPy dicts."""
    from spectrogramgenai_tpu_torch.core import flax_msgpack

    return flax_msgpack.read(ckpt_path)


def build_clap(variables: dict, device: torch.device | str,
               cfg: ClapAudioTowerConfig = ClapAudioTowerConfig()) -> ClapAudioTower:
    """An eval-mode :class:`ClapAudioTower` on ``device`` holding the flax ``variables``."""
    from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax

    model = ClapAudioTower(cfg)
    model.load_state_dict(state_dict_from_flax(model, variables))
    return model.to(device).eval()


def clap_embeddings(wavs: list[np.ndarray], variables: dict | None = None,
                    cfg: ClapAudioTowerConfig = ClapAudioTowerConfig(), batch: int = 8, normalize: bool = True,
                    device: torch.device | str = "cuda", model: ClapAudioTower | None = None) -> np.ndarray:
    """Clips (float arrays at 48 kHz) → (N, projection_dim) float32 CLAP
    embeddings, L2-normalised as laion-clap and frechet_audio_distance do;
    the tower holds ``variables``, or is ``model`` where given."""
    from spectrogramgenai_tpu_torch.core.precision import full_float32

    if model is None:
        model = build_clap(variables, device, cfg)
    device = next(model.parameters()).device
    out = []
    with torch.no_grad(), full_float32():
        for i in range(0, len(wavs), batch):
            out.append(model(clap_input_features(wavs[i : i + batch], model.cfg, device)).cpu().numpy())
    emb = np.concatenate(out, axis=0)
    if normalize:
        emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    return emb
