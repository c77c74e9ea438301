"""Helpers of the mel tests and chip_smoke.py: the stress clips, the rung
bounds and tolerances, and NumPy mirrors of the CUDA mel kernels (``csrc/mel_power.cu``). Imports no JAX.

Each function follows its kernel's index arithmetic line by line: for the
FFT kernel the frame pairs, the Stockham stages' butterfly and twiddle
indices, the split of the two frames' spectra and the mel ranges; for the
mma kernels the shared memory span of a block, the ring of W chunks it
stages, the per-lane ldmatrix and shared-memory loads, and the register layouts that PTX defines for
``mma.sync.m16n8k16`` (bf16 in, f32 out). The CUDA code cannot run without a card; these mirrors let the CPU
tests check that the packed operand layouts of ``ops/mel_kernel.py`` and the
kernels' offsets agree, by computing the same mel power as the plain version.
Sums are taken in float64, so a mirror differs from the plain version only
by rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig, constants
from spectrogramgenai_tpu_torch.ops import mel_kernel as mk

SLOT_STEPS = 16  # 16-sample k-steps of W per slot of the mma kernels' ring
MELS = 256
# the mma kernel's shared memory (csrc/mel_power.cu): a 64 KB ring of W
# chunks and its barriers, then the audio span of a tile of frames, rows
# padded by ROW_PAD bf16; an sm_90 block may hold 227 KB
RING_BYTES, BARRIER_BYTES, ROW_PAD, MAX_SHARED_BYTES, MAX_TILE = 65536, 64, 8, 232448, 96


def mma_tile_frames(cfg: SpectrogramConfig, rung: str) -> int:
    """The frames per block that the mma kernel's launch chooses (mma_tile):
    the largest multiple of 16 up to MAX_TILE whose audio span (bf16, hi and
    lo for "high") fits in shared memory beside the W ring; 0 if none does."""
    parts = 2 if rung == "high" else 1
    for tile in range(MAX_TILE, 0, -16):
        span = 2 * parts * (tile + (cfg.n_fft - 1) // cfg.hop_length) * (cfg.hop_length + ROW_PAD)
        if RING_BYTES + BARRIER_BYTES + span <= MAX_SHARED_BYTES:
            return tile
    return 0


def stress_audio(cfg: SpectrogramConfig, n_clips: int, seed: int = 0) -> np.ndarray:
    """Copy of tools/mel_precision_bench.py:stress_audio (that tool imports JAX):
    clip i is of kind i % 4, float32, ``cfg.clip_samples`` long."""
    rng = np.random.default_rng(seed)
    n = cfg.clip_samples
    t = np.arange(n) / cfg.sample_rate
    clips = []
    for i in range(n_clips):
        kind = i % 4
        if kind == 0:  # loud multitone + quiet tail tone (cancellation stress)
            x = np.sin(2 * np.pi * 440 * t) + 1e-4 * np.sin(2 * np.pi * 9000 * t)
        elif kind == 1:  # broadband noise, wide amplitude range
            x = rng.standard_normal(n) * 10.0 ** rng.uniform(-4, 0)
        elif kind == 2:  # near-silence with a faint chirp
            f0, f1 = 500, 8000
            phase = 2 * np.pi * (f0 * t + (f1 - f0) * t**2 / (2 * t[-1]))
            x = 1e-3 * np.sin(phase) + 1e-6 * rng.standard_normal(n)
        else:  # tone + noise mixture (the reference's actual regime)
            x = 0.5 * np.sin(2 * np.pi * rng.uniform(200, 10000) * t)
            x = x + 0.05 * rng.standard_normal(n)
        clips.append(x.astype(np.float32))
    return np.stack(clips)


# Each rung's error bound against the float64 oracle, in dB, compared as
# written: exact → (typical, adversarial). "Typical" is the max over the
# kind-3 clips of the JAX tool's own 64 (seed 0), "adversarial" the max over
# every clip. The JAX ladder (PARITY.md, mel kernel precision ladder) states
# 0.0005 / 0.0014, 0.009 / 0.047 and 2.4 / 14. Where the rung's own arithmetic
# (the plain version on the CPU, the TPU kernel's rounding of every operand)
# lands above a figure on the tool's 64 clips, the bound is that reading
# rounded up to three significant digits: high adversarial 0.04715 → 0.0472;
# fast 4.705 / 14.14 → 4.71 / 14.2 (the ladder's 2.4 dB "typical" is not the
# max over kind-3 clips: 14 of the 16 are under it, one is at 4.705). The
# kernels on an H100 give the same readings to four digits.
RUNG_BOUNDS = {True: (0.0005, 0.0014), "high": (0.009, 0.0472), False: (4.71, 14.2)}


# mel kernel against plain version: mel_rel_err over the stress clips, just
# above what an H100 gives (3.7e-7, 2.3e-3, 7.6e-3). The exact rung sums the
# DFT in float64 in both and the filterbank product of positive terms in
# float32; "high" sums the bf16 products in float32 in another order, which
# moves the quietest bins (80 dB under the clip's max) by up to 0.01 dB;
# "fast" also rounds a power to the other neighbouring bf16 value on that
# difference (2⁻⁸ of a term).
MEL_TOL = {"exact": 1e-6, "high": 3e-3, "fast": 1e-2}


def mel_rel_err(got: torch.Tensor, want: torch.Tensor, top_db: float = 80.0) -> float:
    """Largest |got − want| / max(want, floor) over (B, T, n_mels) mel power,
    the floor being ``top_db`` below each clip's own max: power_to_db clamps
    every value under it to it, so nothing below it reaches the output. The
    error maps to dB as 10·log10(1 + err)."""
    floor = want.amax(dim=(1, 2), keepdim=True) * 10.0 ** (-top_db / 10)
    floor = floor.clamp_min(torch.finfo(torch.float32).tiny)
    return ((got - want).abs() / torch.maximum(want, floor)).max().item()


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy().astype(np.float64)


def _halves(words: np.ndarray) -> np.ndarray:
    """uint32 words → (…, 2) float64: the bf16 in the low half first."""
    w = words.astype(np.uint32)
    lo = (w & 0xFFFF) << 16
    hi = w & 0xFFFF0000
    return np.stack([lo.view(np.float32), hi.view(np.float32)], -1).astype(np.float64)


def _mma(acc: np.ndarray, a: list[np.ndarray], b0: np.ndarray, b1: np.ndarray) -> None:
    """acc (32, 4) += A·B for one warp, with A's 4 and B's 2 registers per lane
    given as (32, 2) value pairs, in the PTX fragment layouts of m16n8k16."""
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for e in range(2):
        A[g, 2 * q + e] = a[0][:, e]
        A[g + 8, 2 * q + e] = a[1][:, e]
        A[g, 2 * q + 8 + e] = a[2][:, e]
        A[g + 8, 2 * q + 8 + e] = a[3][:, e]
        B[2 * q + e, g] = b0[:, e]
        B[2 * q + 8 + e, g] = b1[:, e]
    D = A @ B
    for e in range(2):
        acc[:, e] += D[g, 2 * q + e]
        acc[:, 2 + e] += D[g + 8, 2 * q + e]


def _ldsm_x4(buf: np.ndarray, addrs: np.ndarray) -> list[np.ndarray]:
    """ldmatrix.x4 (no .trans) from the bf16 array ``buf``: lanes 8i … 8i + 7
    give the element offsets of the rows of matrix i; register i of lane l
    is row l // 4, columns 2·(l % 4) and + 1 of matrix i, as (32, 2)."""
    lane = np.arange(32)
    return [np.stack([buf[addrs[8 * i + lane // 4] + 2 * (lane % 4) + e] for e in range(2)], -1)
            for i in range(4)]


def mma_kernel(audio: np.ndarray, cfg: SpectrogramConfig, rung: str) -> np.ndarray:
    """mel_power_mma_kernel<PARTS> (PARTS 2 for "high", 1 for "fast"): a block
    of a warp per 16 frames per tile of frames, W streamed through a ring of chunks of 16
    (or 4) k-steps (bulk copies; a slot is refilled once every warp has left it)."""
    parts = 2 if rung == "high" else 1
    wc, ws = mk._dft(cfg)
    w, fb, nbp = mk.mma_layout(wc, ws, np.ascontiguousarray(constants(cfg)[1].T), rung)
    wf, fbf = w.reshape(-1, 4), fb.reshape(-1, 4)  # uint4 arrays
    bsz, n = audio.shape
    n_fft, hop = cfg.n_fft, cfg.hop_length
    pad = n_fft // 2 if cfg.center else 0
    t_frames = cfg.frames_for(n)
    tile = mma_tile_frames(cfg, rung)
    span_rows, stride = tile + (n_fft - 1) // hop, hop + ROW_PAD
    steps, n_jb = n_fft // 16, nbp // 16
    step_words = parts * 64  # uint4 per k-step
    stages = RING_BYTES // (16 * SLOT_STEPS * step_words)
    chunk = SLOT_STEPS if steps % SLOT_STEPS == 0 else 4  # k-steps per chunk
    per_jb = steps // chunk
    n_chunks = n_jb * per_jb
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    out = np.zeros((bsz, t_frames, cfg.n_mels))
    for b in range(bsz):
        for f_base in range(0, t_frames, tile):
            r, c = np.divmod(np.arange(span_rows * hop), hop)
            s = (f_base + r) * hop + c - pad
            v = np.where((s >= 0) & (s < n), audio[b, np.clip(s, 0, n - 1)], 0.0).astype(np.float32)
            span = np.zeros((2, span_rows * stride))  # the audio's bf16 hi and lo
            span[0, r * stride + c] = _bf16(v)
            if parts == 2:
                span[1, r * stride + c] = _bf16(v - _bf16(v))
            ring = np.zeros((stages, SLOT_STEPS * step_words, 4), np.uint32)

            def stage(ci):
                if ci < n_chunks:
                    ring[ci % stages, :chunk * step_words] = wf[ci * chunk * step_words:(ci + 1) * chunk * step_words]

            for ci in range(stages):
                stage(ci)
            warps = [wp for wp in range(tile // 16) if f_base + 16 * wp < t_frames]
            mel = {wp: np.zeros((MELS // 8, 32, 4)) for wp in warps}
            ci = 0
            for jb in range(n_jb):
                acc = {wp: np.zeros((4, 2, 32, 4)) for wp in warps}  # re, im, re_c, im_c
                offs = {wp: (16 * wp + (lane & 15)) * stride + ((lane >> 4) << 3) for wp in warps}
                col = 0
                for _ in range(per_jb):
                    if ci >= 1:  # the slot of chunk ci − 1, which every warp has left
                        stage(ci - 1 + stages)
                    slot = ring[ci % stages]
                    for i in range(chunk):
                        ws_ = i * step_words + lane
                        bc, bs = _halves(slot[ws_]), _halves(slot[ws_ + 32])  # (32, 4 words, 2)
                        if parts == 2:
                            lc, ls = _halves(slot[ws_ + 64]), _halves(slot[ws_ + 96])
                        for wp in warps:
                            re, im, re_c, im_c = acc[wp]
                            a = _ldsm_x4(span[0], offs[wp])
                            for t in range(2):
                                _mma(re[t], a, bc[:, 2 * t], bc[:, 2 * t + 1])
                                _mma(im[t], a, bs[:, 2 * t], bs[:, 2 * t + 1])
                            if parts == 2:
                                al = _ldsm_x4(span[1], offs[wp])
                                for t in range(2):
                                    _mma(re_c[t], al, bc[:, 2 * t], bc[:, 2 * t + 1])
                                    _mma(im_c[t], al, bs[:, 2 * t], bs[:, 2 * t + 1])
                                    _mma(re_c[t], a, lc[:, 2 * t], lc[:, 2 * t + 1])
                                    _mma(im_c[t], a, ls[:, 2 * t], ls[:, 2 * t + 1])
                            offs[wp] = offs[wp] + 16
                        col += 16
                        if col == hop:  # on to the next span row
                            col = 0
                            for wp in warps:
                                offs[wp] = offs[wp] + ROW_PAD
                    ci += 1
                for wp in warps:
                    re, im, re_c, im_c = acc[wp]
                    pw = ((re + re_c) ** 2 + (im + im_c) ** 2).astype(np.float32)  # (2, 32, 4)
                    hi = _bf16(pw)
                    ph = [hi[0][:, 0:2], hi[0][:, 2:4], hi[1][:, 0:2], hi[1][:, 2:4]]
                    lo = _bf16(pw - hi)
                    pl = [lo[0][:, 0:2], lo[0][:, 2:4], lo[1][:, 0:2], lo[1][:, 2:4]]
                    fp = jb * (MELS // 16) * parts * 32 + lane
                    for u2 in range(MELS // 16):
                        fh = _halves(fbf[fp + u2 * parts * 32])
                        for t in range(2):
                            _mma(mel[wp][2 * u2 + t], ph, fh[:, 2 * t], fh[:, 2 * t + 1])
                        if parts == 2:
                            fl = _halves(fbf[fp + u2 * parts * 32 + 32])
                            for t in range(2):
                                _mma(mel[wp][2 * u2 + t], ph, fl[:, 2 * t], fl[:, 2 * t + 1])
                                _mma(mel[wp][2 * u2 + t], pl, fh[:, 2 * t], fh[:, 2 * t + 1])
            for wp in warps:
                for h in range(2):
                    f = f_base + 16 * wp + g + 8 * h
                    for u in range(MELS // 8):
                        for e in range(2):
                            col_ = u * 8 + 2 * q + e
                            ok = (f < t_frames) & (col_ < cfg.n_mels)
                            out[b, f[ok], col_[ok]] = mel[wp][u][ok, 2 * h + e]
    return out.astype(np.float32)


def fft_kernel(audio: np.ndarray, cfg: SpectrogramConfig) -> np.ndarray:
    """mel_power_fft_kernel<LOG2N>, all pairs of frames of a clip at once."""
    win, tw, ranges, mel_w = mk.fft_constants(cfg)
    tw = tw[:, 0] + 1j * tw[:, 1]
    bsz, n = audio.shape
    n_fft, hop = cfg.n_fft, cfg.hop_length
    pad = n_fft // 2 if cfg.center else 0
    t_frames = cfg.frames_for(n)
    k_bins = n_fft // 2 + 1
    log2n = n_fft.bit_length() - 1
    out = np.zeros((bsz, t_frames, cfg.n_mels), np.float32)
    pairs = np.arange((t_frames + 1) // 2)[:, None]
    i = np.arange(n_fft)[None]
    f0, f1 = 2 * pairs, 2 * pairs + 1
    for b in range(bsz):
        x = audio[b].astype(np.float64)
        a, c = f0 * hop - pad + i, f1 * hop - pad + i
        re = np.where((a >= 0) & (a < n), x[np.clip(a, 0, n - 1)], 0.0) * win
        im = np.where((f1 < t_frames) & (c >= 0) & (c < n), x[np.clip(c, 0, n - 1)], 0.0) * win
        cur = re + 1j * im  # (pairs, n_fft)
        p = 1
        for radix in ([2] if log2n % 2 else []) + [4] * (log2n // 2):
            t = n_fft // radix
            bi = np.arange(t)
            k = bi & (p - 1)
            step = k * (n_fft // (radix * p))
            u = [cur[:, bi + r * t] * tw[r * step] for r in range(radix)]
            j = (bi - k) * radix + k
            nxt = np.empty_like(cur)
            if radix == 2:
                nxt[:, j], nxt[:, j + p] = u[0] + u[1], u[0] - u[1]
            else:
                a_, b_ = u[0] + u[2], u[0] - u[2]
                c_, d_ = u[1] + u[3], u[1] - u[3]
                nxt[:, j], nxt[:, j + 2 * p] = a_ + c_, a_ - c_
                nxt[:, j + p], nxt[:, j + 3 * p] = b_ - 1j * d_, b_ + 1j * d_
            cur, p = nxt, p * radix
        kk = np.arange(k_bins)
        z, w = cur[:, kk], cur[:, (n_fft - kk) & (n_fft - 1)]
        spec_a, spec_b = 0.5 * (z + np.conj(w)), 0.5 * (z - np.conj(w)) / 1j
        for power, f in ((np.abs(spec_a) ** 2, f0[:, 0]), (np.abs(spec_b) ** 2, f1[:, 0])):
            ok = f < t_frames
            for m, (first, count, offset, _) in enumerate(ranges):
                mel = power[:, first:first + count] @ mel_w[offset:offset + count]
                out[b, f[ok], m] = mel[ok]
    return out
