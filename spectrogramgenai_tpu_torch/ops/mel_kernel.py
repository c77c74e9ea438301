"""Fused wav → mel power spectrogram: framing, Hann window, |DFT|², mel filterbank.

Counterpart of ``spectrogramgenai_tpu/ops/mel_kernel.py``. On a CUDA tensor
:func:`fused_mel_power` launches the hand-written kernels of
``csrc/mel_power.cu`` or raises; on a CPU tensor it computes
:func:`mel_power_reference`, the plain PyTorch version of the same function.
There is no other path.

``exact`` picks the precision rung, as the JAX package's does, and each
rung meets that rung's error bound against the float64 oracle (PARITY.md):

  True    the default (the JAX kernel's HIGHEST): the float64 oracle's own
          arithmetic — frames times the float32 window in float64, a
          float64 FFT, power and filterbank sums in float64, one rounding
          to float32 (the kernel: an FFT in shared memory, two frames per
          complex transform, each mel summed over its nonzero bins);
  "high"  every product as three bf16 products of hi/lo splits,
          a_hi·b_hi + a_hi·b_lo + a_lo·b_hi (bf16_3x), f32 accumulation;
  False   the fastest (the JAX kernel's DEFAULT): every product as one
          bf16 product of operands rounded to bf16, f32 accumulation.

The plain version rounds its operands exactly as the kernels do, so kernel
and plain version differ only by the order of summation (for the exact
rung: an FFT's order against ``torch.fft.rfft``'s, both in float64), and
each rung's error against the float64 oracle can be tested on the CPU.
For "high" the plain version sums its three products in float64 and rounds
to float32 where the kernel stores a float32 value (re, im, the power, the
output): at n_fft 4096 float32 sums of its own would differ from the plan
by more than the kernel's.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from spectrogramgenai_tpu_torch.audio import mel as melmath
from spectrogramgenai_tpu_torch.audio.spectrogram import (
    SpectrogramConfig,
    constants,
    frame_signal,
    power_to_db,
)
from spectrogramgenai_tpu_torch.ops import _build

_RUNG_CODES = {"high": 1, "fast": 2}  # mel_power's `rung` argument; "exact" is mel_power_fft
MAX_MELS = 256  # width of the kernels' mel accumulator
FFT_SIZES = tuple(2**e for e in range(6, 13))  # the exact rung's n_fft: 64 … 4096


def rung_name(exact) -> str:
    """``exact`` (True, "high" or False) → "exact", "high" or "fast"."""
    if exact is True:
        return "exact"
    if exact is False:
        return "fast"
    if exact == "high":
        return "high"
    raise ValueError(f"exact must be True, 'high' or False, got {exact!r}")


def split_bf16(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 → (hi, lo) bfloat16 with a ≈ hi + lo (round to nearest even)."""
    hi = a.to(torch.bfloat16)
    lo = (a - hi.float()).to(torch.bfloat16)
    return hi, lo


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float()


def _bf16_3x(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the "high" rung's three products a_hi·b_hi + a_hi·b_lo + a_lo·b_hi,
    summed in float64 (each bf16 part and each product of two is exact
    there) and rounded once to float32, where the kernel stores the value."""
    ah, al = (t.double() for t in split_bf16(a))
    bh, bl = (t.double() for t in split_bf16(b))
    return (ah @ bh + ah @ bl + al @ bh).float()


def _dft_product(frames: torch.Tensor, w: torch.Tensor, rung: str) -> torch.Tensor:
    """frames @ w, with the operands rounded and the products taken as the rung's kernel does."""
    if rung == "fast":
        return _bf16(frames) @ _bf16(w)
    return _bf16_3x(frames, w)


def _mel_product(power: torch.Tensor, fb_t: torch.Tensor, rung: str) -> torch.Tensor:
    """power @ fbᵀ in float32, rounded as the rung's kernel rounds it."""
    if rung == "fast":
        return _bf16(power) @ _bf16(fb_t)
    return _bf16_3x(power, fb_t)


@functools.lru_cache(maxsize=16)
def _dft(cfg: SpectrogramConfig) -> tuple[np.ndarray, np.ndarray]:
    return melmath.dft_matrices(cfg.n_fft, constants(cfg)[0], dtype=np.float32)


def _check_cfg(cfg: SpectrogramConfig) -> None:
    if cfg.power != 2.0:
        raise ValueError(f"the fused mel path computes power 2 (re² + im²), got power={cfg.power}")


def mel_power_reference(audio: torch.Tensor, cfg: SpectrogramConfig, exact=True) -> torch.Tensor:
    """Plain version: (B, N) → (B, T, n_mels) float32 mel power, by framing
    with ``unfold``; the exact rung then takes ``torch.fft.rfft`` and the
    filterbank product in float64, the others the window-folded DFT and the
    filterbank as matmuls rounded as their kernel rounds them."""
    rung = rung_name(exact)
    _check_cfg(cfg)
    frames = frame_signal(audio.float(), cfg)  # (B, T, n_fft)
    window, fb = constants(cfg)
    if rung == "exact":
        spec = torch.fft.rfft(frames.double() * torch.from_numpy(window).to(audio.device).double(), dim=-1)
        power = spec.real.square() + spec.imag.square()
        return (power @ torch.from_numpy(fb).to(audio.device).double().T).float()
    wc, ws = (torch.from_numpy(w).to(audio.device) for w in _dft(cfg))
    re, im = _dft_product(frames, wc, rung), _dft_product(frames, ws, rung)
    power = (re * re + im * im).float()
    fb_t = torch.from_numpy(np.ascontiguousarray(fb.T)).to(audio.device)
    return _mel_product(power, fb_t, rung)


# ---------------------------------------------------------------------------
# The kernels' constants, laid out in the order the threads read them
# (csrc/mel_power.cu). Built once per (config, device, rung).
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _parts(a: np.ndarray, rung: str) -> np.ndarray:
    """(…) float32 → (P, …) bf16 bits: [a] for "fast", [hi, lo] for "high"."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    parts = [t.to(torch.bfloat16)] if rung == "fast" else list(split_bf16(t))
    return np.stack([p.view(torch.int16).numpy().view(np.uint16) for p in parts])


def fft_constants(cfg: SpectrogramConfig):
    """Exact rung (mel_power_fft_kernel): the window as (n_fft,) float64
    holding the float32 values; the twiddles as (n_fft, 2) float64,
    exp(−2πi·m/n_fft) from np.exp; per mel filter (first bin, bin count,
    offset into the weights, 0) as (n_mels, 4) int32, the range running from
    the filter's first to its last nonzero bin (count 0 for an empty
    filter); and the weights of every range, back to back, as float64
    holding the float32 filterbank values."""
    window, fb = constants(cfg)
    n = cfg.n_fft
    tw = np.exp(-2j * np.pi * np.arange(n) / n)
    ranges = np.zeros((fb.shape[0], 4), np.int32)
    weights = []
    offset = 0
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        first, count = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if len(nz) else (0, 0)
        ranges[m, :3] = first, count, offset
        weights.append(row[first:first + count])
        offset += count
    return (window.astype(np.float64), np.stack([tw.real, tw.imag], -1), ranges,
            np.concatenate(weights).astype(np.float64))


def mma_layout(wc: np.ndarray, ws: np.ndarray, fb_t: np.ndarray, rung: str):
    """high / fast rungs: the B operands of mma.m16n8k16 (bf16), per lane.

    W: (nbp/16, n_fft/16, P, 2, 32, 4) uint32: for bin block j, sample step s,
    part p (hi, lo), matrix m (Wc, Ws) and lane l = 4g + q, the words
    {n8 tile 0: b01, b23; tile 1: b01, b23}, where b01 packs rows
    16s + 2q + {0, 1} and b23 rows 16s + 2q + 8 + {0, 1} (the lower row in the
    low half) of column 16j + 8t + g.
    fbᵀ: (nbp/16, 16, P, 32, 4) uint32: for bin block j, mel tile pair u2,
    part p and lane, {tile 2·u2: b01, b23; tile 2·u2 + 1: b01, b23} with rows
    16j + 2q + {0, 1} (+8) and column 8·(2·u2 + t) + g.
    W is in (j, s) order, so the 16 (or 4) steps of one bin block that the
    kernel stages in shared memory as one chunk are one contiguous run.
    """
    n_fft, n_bins = wc.shape
    nbp = _round_up(n_bins, 16)
    w = np.zeros((2, n_fft, nbp), np.float32)
    w[0, :, :n_bins], w[1, :, :n_bins] = wc, ws
    wb = _parts(w, rung)  # (P, 2, n_fft, nbp)
    fb = np.zeros((nbp, MAX_MELS), np.float32)
    fb[:n_bins, : fb_t.shape[1]] = fb_t
    fbb = _parts(fb, rung)  # (P, nbp, 256)
    n_parts = wb.shape[0]

    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    # W: axes (j, s, p, m, lane, t, h, e)
    j = np.arange(nbp // 16).reshape(-1, 1, 1, 1, 1, 1, 1, 1)
    s = np.arange(n_fft // 16).reshape(1, -1, 1, 1, 1, 1, 1, 1)
    p = np.arange(n_parts).reshape(1, 1, -1, 1, 1, 1, 1, 1)
    m = np.arange(2).reshape(1, 1, 1, -1, 1, 1, 1, 1)
    gl, ql = g.reshape(1, 1, 1, 1, -1, 1, 1, 1), q.reshape(1, 1, 1, 1, -1, 1, 1, 1)
    t = np.arange(2).reshape(1, 1, 1, 1, 1, -1, 1, 1)
    h = np.arange(2).reshape(1, 1, 1, 1, 1, 1, -1, 1)
    e = np.arange(2).reshape(1, 1, 1, 1, 1, 1, 1, -1)
    w_frag = wb[p, m, 16 * s + 2 * ql + 8 * h + e, 16 * j + 8 * t + gl]
    w_frag = np.ascontiguousarray(w_frag).view(np.uint32)[..., 0].reshape(
        nbp // 16, n_fft // 16, n_parts, 2, 32, 4)
    # fbᵀ: axes (j, u2, p, lane, t, h, e)
    j = np.arange(nbp // 16).reshape(-1, 1, 1, 1, 1, 1, 1)
    u2 = np.arange(MAX_MELS // 16).reshape(1, -1, 1, 1, 1, 1, 1)
    p = np.arange(n_parts).reshape(1, 1, -1, 1, 1, 1, 1)
    gl, ql = g.reshape(1, 1, 1, -1, 1, 1, 1), q.reshape(1, 1, 1, -1, 1, 1, 1)
    t = np.arange(2).reshape(1, 1, 1, 1, -1, 1, 1)
    h = np.arange(2).reshape(1, 1, 1, 1, 1, -1, 1)
    e = np.arange(2).reshape(1, 1, 1, 1, 1, 1, -1)
    fb_frag = fbb[p, 16 * j + 2 * ql + 8 * h + e, 8 * (2 * u2 + t) + gl]
    fb_frag = np.ascontiguousarray(fb_frag).view(np.uint32)[..., 0].reshape(
        nbp // 16, MAX_MELS // 16, n_parts, 32, 4)
    return w_frag, fb_frag, nbp


@functools.lru_cache(maxsize=8)
def _kernel_constants(cfg: SpectrogramConfig, device: torch.device, rung: str) -> tuple:
    """The rung's constants on the device: fft_constants for "exact", else
    (W, fbᵀ, nbp) of mma_layout."""
    if rung == "exact":
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in fft_constants(cfg))
    wc, ws = _dft(cfg)
    w, fb, nbp = mma_layout(wc, ws, np.ascontiguousarray(constants(cfg)[1].T), rung)
    # uint32 words travel as int32 (torch has no uint32 arithmetic, and needs none here)
    return torch.from_numpy(w.view(np.int32)).to(device), torch.from_numpy(fb.view(np.int32)).to(device), nbp


def _kernel() -> ctypes.CDLL:
    lib = _build.load("mel_power")
    if lib.mel_power.argtypes is None:  # first use: declare the C signatures
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mel_power.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        lib.mel_power.restype = ctypes.c_int
        lib.mel_power_fft.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.mel_power_fft.restype = ctypes.c_int
        lib.mel_power_error_string.argtypes = [ctypes.c_int]
        lib.mel_power_error_string.restype = ctypes.c_char_p
    return lib


def _check(audio: torch.Tensor, cfg: SpectrogramConfig) -> None:
    if audio.dim() != 2:
        raise ValueError(f"audio must be (B, N), got shape {tuple(audio.shape)}")
    if audio.dtype != torch.float32:
        raise TypeError(f"audio must be float32, got {audio.dtype}")
    if audio.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {audio.device}")
    if not audio.is_contiguous():
        raise ValueError("audio must be contiguous")
    if audio.shape[0] == 0 or cfg.frames_for(audio.shape[1]) < 1:
        raise ValueError(f"no frames in audio of shape {tuple(audio.shape)} at n_fft {cfg.n_fft}")
    _check_cfg(cfg)


def fused_mel_power(audio: torch.Tensor, cfg: SpectrogramConfig, exact=True) -> torch.Tensor:
    """(B, N) float32 audio → (B, T, n_mels) float32 mel power, T = cfg.frames_for(N).

    Inputs are validated before the device is looked at.
    ``fused_mel_power.launches`` counts kernel launches."""
    rung = rung_name(exact)
    _check(audio, cfg)
    if audio.device.type == "cpu":
        return mel_power_reference(audio, cfg, exact)
    fft_ok = cfg.n_fft in FFT_SIZES if rung == "exact" else cfg.n_fft % 64 == 0
    if not fft_ok or cfg.hop_length % 16 or cfg.n_mels > MAX_MELS:
        sizes = "a power of two from 64 to 4096" if rung == "exact" else "a multiple of 64"
        raise ValueError(f"the {rung} mel kernel takes n_fft {sizes}, hop % 16 == 0 and n_mels ≤ {MAX_MELS}; "
                         f"got n_fft {cfg.n_fft}, hop {cfg.hop_length}, n_mels {cfg.n_mels}")
    b, n = audio.shape
    t = cfg.frames_for(n)
    pad = cfg.n_fft // 2 if cfg.center else 0
    lib = _kernel()
    consts = _kernel_constants(cfg, audio.device, rung)
    out = torch.empty(b, t, cfg.n_mels, dtype=torch.float32, device=audio.device)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream().cuda_stream
        if rung == "exact":
            err = lib.mel_power_fft(audio.data_ptr(), *(c.data_ptr() for c in consts), out.data_ptr(), b, n, t,
                                    cfg.n_fft, cfg.hop_length, pad, cfg.n_mels, stream)
        else:
            w, fb, nbp = consts
            err = lib.mel_power(audio.data_ptr(), w.data_ptr(), fb.data_ptr(), out.data_ptr(), b, n, t,
                                cfg.n_fft, cfg.hop_length, pad, nbp, cfg.n_mels, _RUNG_CODES[rung], stream)
    if err != 0:
        msg = lib.mel_power_error_string(err).decode()
        raise RuntimeError(f"mel_power ({rung}) launch failed: {msg} (cudaError {err})")
    fused_mel_power.launches += 1
    return out


fused_mel_power.launches = 0


def logmel_from_power(mel: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    """(B, T, n_mels) mel power → (B, n_mels, num_frames) dB: the per-sample
    ``ref=max`` dB conversion over the full spectrogram, then the crop to
    ``cfg.num_frames``, as tensor ops (the dB glue)."""
    return power_to_db(mel.transpose(1, 2), amin=cfg.amin, top_db=cfg.top_db)[..., : cfg.num_frames]


def fused_logmel(audio: torch.Tensor, cfg: SpectrogramConfig, exact=True) -> torch.Tensor:
    """(B, N) → (B, n_mels, num_frames) log-mel in dB: the kernel's mel power, then the dB glue."""
    return logmel_from_power(fused_mel_power(audio, cfg, exact=exact), cfg)
