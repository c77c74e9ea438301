#!/usr/bin/env python3
"""Drive the PyTorch port's serving path and mel front end once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught and passed over):

  1. device   — CUDA must be available; prints the card's name and power limit
                (nvidia-smi).
  2. build    — compiles csrc/attention_fwd.cu and csrc/mel_power.cu with nvcc
                from this checkout, one nvcc per source, started together;
                prints each kernel's registers and spills.
  3. kernel   — the attention kernel against its plain PyTorch version at the
                UNet's three fused sites (B·H = 216 = serve batch 27 × CFG 2
                × 4 heads): f32 ≤ 1e-4 with TF32 off, bf16 ≤ 1e-2 against the
                f32 upcast of the same inputs, a large-logit row, and the
                small head dims; kernel, plain and scaled_dot_product_attention
                times (CUDA events, median) and the bound.
  4. mel      — each mel kernel rung (exact, high, fast) against its plain
                version (per element, down to 80 dB under each clip's max)
                and the float64 oracle on the stress clips of
                tools/mel_precision_bench.py (its own 64 at 22,050 Hz, 4 clips
                at 48 kHz, 5 of odd length), within each rung's dB bounds
                (tests/torch_mel_helpers.py; typical: kind 3 of the tool's 64;
                adversarial: every clip); kernel, plain and torch.stft +
                filterbank times at batch 64.
  5. serve    — the full-width latent DDPM (UNet width 1.0, 27 classes,
                64×64×4 latent; VQ-VAE hidden 512, 512 codes) with seeded
                random weights, saved as checkpoints and served through
                cli.serve.run (DPM-Solver++ 20 steps, serve batch 27);
                concurrent POST /generate requests for 32 images, /healthz and
                /stats; every batch must have gone through the kernel.
  6. gen_specs — a synthetic corpus (32 recordings of 60 s at 22,050 Hz and 2
                at 48 kHz, 8 detections each) through cli.gen_specs.run on the
                card, once per rung: every PNG written and 256×256×3, the
                exact .npy arrays at the exact rung's bound against the oracle,
                exact and high PNGs within 2 levels, a kernel launch per batch;
                specs/s and the decode / mel kernel / dB glue / encode split.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when CUDA
is absent or any check fails.
"""

from __future__ import annotations

import base64
import contextlib
import csv
import io
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SERVE_BATCH = 27
NUM_STEPS = 20
SA_SITES = (("sa_0", 1024, 32), ("sa_4", 1024, 16), ("sa_5", 4096, 16))  # name, N, head dim
BH = SERVE_BATCH * 2 * 4
REQUESTS = ({"label": "class00", "count": 1}, {"label": 5, "count": 4}, {"label": 26, "count": 27})
KERNEL_SOURCES = ("attention_fwd", "mel_power")
# H100 SXM peaks (NVIDIA's data sheet): memory rate, bf16 tensor cores, and the
# scalar float32 rate, which is also the float64 tensor-core rate
H100_BYTES_PER_S, H100_BF16_FLOPS, H100_F32_FLOPS = 3.35e12, 989e12, 67e12
MEL_RUNGS = ((True, "exact", "spectrogramgenai_tpu/ops/mel_kernel.py:94"),
             ("high", "high", "spectrogramgenai_tpu/ops/mel_kernel.py:147"),
             (False, "fast", "spectrogramgenai_tpu/ops/mel_kernel.py:94"))
# (bf16 products of the DFT, of the filterbank product) per rung
MEL_PRODUCTS = {"exact": (1, 1), "high": (3, 3), "fast": (1, 1)}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, runs: int = 10, warmup: int = 3, inner: int = 1) -> float:
    """Median device time of one fn() in ms: each run is ``inner`` back-to-back
    calls between two CUDA events, so that the host can enqueue ahead."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def png_rgb(png: bytes) -> np.ndarray:
    """The (height, width, 3) pixels of an 8-bit RGB PNG with no row filters
    (the port's encoder), after checking its header and inflated size."""
    check(png.startswith(b"\x89PNG\r\n\x1a\n"), "PNG signature")
    pos, idat, ihdr = 8, b"", None
    while pos < len(png):
        (length,) = struct.unpack(">I", png[pos:pos + 4])
        kind, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat += data
        pos += 12 + length
    check(ihdr is not None and ihdr[2:4] == (8, 2), "8-bit RGB IHDR")
    w, h = ihdr[0], ihdr[1]
    raw = zlib.decompress(idat)
    check(len(raw) == h * (1 + 3 * w), "inflated PNG size")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), "unfiltered PNG rows")
    return rows[:, 1:].reshape(h, w, 3)


def exact64(q, k, v):
    """softmax(q·kᵀ/√d)·v computed in float64 (the plain version computes in float32)."""
    import torch

    q, k, v = q.double(), k.double(), v.double()
    return torch.softmax((q @ k.mT) / math.sqrt(q.shape[-1]), dim=-1) @ v


def phase_kernel(torch, attn) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    ref, fused = attn.attention_reference, attn.fused_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention  # the yardstick; the port never calls it

    def rand(n, d, dtype):
        return [torch.randn(1, BH, n, d, device="cuda", generator=gen).to(dtype) for _ in range(3)]

    max_err, ms, plain_ms, library_ms, flops_ms, bytes_ms = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
    for name, n, d in SA_SITES:
        q, k, v = rand(n, d, torch.float32)
        err32 = (fused(q, k, v) - ref(q, k, v)).abs().max().item()
        torch.cuda.synchronize()
        check(err32 <= 1e-4, f"{name} f32 max abs err {err32} <= 1e-4")

        qb, kb, vb = (t.bfloat16() for t in (q, k, v))
        out = fused(qb, kb, vb)
        check(out.dtype == torch.bfloat16, "bf16 output dtype")
        err16 = (out.float() - ref(qb.float(), kb.float(), vb.float())).abs().max().item()
        check(err16 <= 1e-2, f"{name} bf16 max abs err {err16} <= 1e-2")

        # large logits (q×100, |logit| in the hundreds): the online softmax must
        # neither overflow nor flatten. At that size f32 rounding of the logit
        # itself (~|s|·2⁻²⁴·√d ≈ 1e-4) moves the weights of near-tied keys by
        # that much in any f32 summation order, the plain version's included,
        # so both are held to a float64 reference, on the first 54 heads (the
        # f64 scores stay under 8 GB).
        ql, ks, vs = q[:, :54] * 100.0, k[:, :54].contiguous(), v[:, :54].contiguous()
        big = fused(ql, ks, vs)
        check(bool(torch.isfinite(big).all()), f"{name} large-logit output finite")
        exact = exact64(ql, ks, vs)
        errl = (big.double() - exact).abs().max().item()
        errl_plain = (ref(ql, ks, vs).double() - exact).abs().max().item()
        check(errl <= 1e-3, f"{name} f32 large-logit max abs err vs f64 {errl} <= 1e-3")
        qlb, ksb, vsb = ql.bfloat16(), ks.bfloat16(), vs.bfloat16()
        want = exact64(qlb, ksb, vsb)
        # one-hot rows copy a V entry (|v| up to ~5): bf16 rounds 2⁻⁸ relative
        errlb = ((fused(qlb, ksb, vsb).double() - want).abs() / want.abs().clamp(min=1.0)).max().item()
        check(errlb <= 1e-2, f"{name} bf16 large-logit max rel err {errlb} <= 1e-2")

        t_k = cuda_ms(lambda: fused(qb, kb, vb))
        t_p = cuda_ms(lambda: ref(qb, kb, vb))
        t_k32 = cuda_ms(lambda: fused(q, k, v))
        t_p32 = cuda_ms(lambda: ref(q, k, v))
        t_lib = cuda_ms(lambda: sdpa(qb, kb, vb))
        # least time for the bf16 work: q·kᵀ and p·v on the tensor cores, or
        # q, k, v read and o written once; the exponentials (MUFU, 16 per
        # clock per SM) are a third bound, printed beside
        flops, nbytes, exps = 4 * BH * n * n * d, 4 * BH * n * d * 2, BH * n * n
        t_flops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        log(f"kernel {name} (B·H={BH}, N={n}, d={d}): err f32 {err32:.3g} bf16 {err16:.3g} "
            f"large-logit vs f64: f32 {errl:.3g} (plain f32 {errl_plain:.3g}), bf16(rel) {errlb:.3g} | "
            f"bf16 kernel {t_k:.3f} ms, plain {t_p:.3f} ms, scaled_dot_product_attention {t_lib:.3f} ms | "
            f"f32 kernel {t_k32:.3f} ms, plain {t_p32:.3f} ms | bound {max(t_flops, t_bytes):.4f} ms "
            f"(tensor-core flops {t_flops:.4f}, bytes {t_bytes:.4f}; {exps:.3g} exponentials)")
        max_err = max(max_err, err32, err16)
        ms += t_k
        plain_ms += t_p
        library_ms += t_lib
        flops_ms += t_flops
        bytes_ms += t_bytes
        del q, k, v, qb, kb, vb, out, ql, ks, vs, big, exact, qlb, ksb, vsb, want
        torch.cuda.empty_cache()

    # the other compiled head dims (narrow widths, as in tests/test_torch_cuda.py)
    for d in (2, 4, 8, 64):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            q, k, v = rand(1024, d, dtype)
            err = (fused(q, k, v).float() - ref(q.float(), k.float(), v.float())).abs().max().item()
            check(err <= tol, f"d={d} {dtype} max abs err {err} <= {tol}")
    torch.cuda.synchronize()
    bound_ms = max(flops_ms, bytes_ms)
    log(f"kernel: head dims 2, 4, 8, 64 match in f32 and bf16; three-site sum bf16 kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, scaled_dot_product_attention {library_ms:.3f} ms, bound {bound_ms:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes", "library_ms": library_ms}


def phase_mel(torch) -> dict[str, dict]:
    """Each rung's kernel against its plain version and the float64 oracle; times at batch 64."""
    from spectrogramgenai_tpu_torch.audio.mel import hann_window
    from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig, constants, reference_logmel_np
    from spectrogramgenai_tpu_torch.ops import mel_kernel as mk

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_mel_helpers import MEL_TOL, RUNG_BOUNDS, mel_rel_err, stress_audio

    cfg, cfg48 = SpectrogramConfig(), SpectrogramConfig(sample_rate=48000)
    sets = [("22,050 Hz × 64", cfg, stress_audio(cfg, 64)),
            ("48 kHz × 4", cfg48, stress_audio(cfg48, 4, seed=1)),
            ("100,001 samples × 5", cfg, np.ascontiguousarray(stress_audio(cfg, 5, seed=2)[:, :100_001]))]
    oracles = [np.stack([reference_logmel_np(c, set_cfg) for c in clips]) for _, set_cfg, clips in sets]
    audio64 = torch.from_numpy(sets[0][2]).cuda()
    b, n = audio64.shape
    t_frames = cfg.frames_for(n)

    # the yardstick: one cuFFT STFT (zero centre padding, periodic Hann) and the
    # filterbank matmul, float32 with TF32 off; the port never calls it
    window = torch.from_numpy(hann_window(cfg.n_fft)).cuda()
    fb_t = torch.from_numpy(np.ascontiguousarray(constants(cfg)[1].T)).cuda()

    def library():
        spec = torch.stft(audio64, cfg.n_fft, cfg.hop_length, window=window, center=True, pad_mode="constant",
                          return_complex=True)
        return (spec.abs() ** 2).transpose(1, 2) @ fb_t

    lib_out = library()
    exact_plain = mk.mel_power_reference(audio64, cfg, True)
    lib_rel = ((lib_out - exact_plain).abs().max() / exact_plain.abs().max()).item()
    check(lib_out.shape == exact_plain.shape and lib_rel <= 1e-4, f"torch.stft yardstick agrees ({lib_rel:.3g})")
    t_lib = cuda_ms(library)
    log(f"mel: torch.stft + filterbank (batch {b}, f32): {t_lib:.3f} ms, rel. diff to the exact plain version "
        f"{lib_rel:.3g}")
    del lib_out, exact_plain

    out, failed = {}, []
    for exact, rung, replaces in MEL_RUNGS:
        typical_bound, adversarial_bound = RUNG_BOUNDS[exact]
        max_abs, max_rel, typical, adversarial = 0.0, 0.0, 0.0, 0.0
        for (name, set_cfg, clips), oracle in zip(sets, oracles):
            audio = torch.from_numpy(clips).cuda()
            got = mk.fused_mel_power(audio, set_cfg, exact)
            want = mk.mel_power_reference(audio, set_cfg, exact)
            torch.cuda.synchronize()
            check(got.shape == (len(clips), set_cfg.frames_for(clips.shape[1]), set_cfg.n_mels),
                  f"mel {rung} {name} shape")
            diff, rel = (got - want).abs().max().item(), mel_rel_err(got, want)
            err = np.abs(mk.fused_logmel(audio, set_cfg, exact).cpu().numpy() - oracle).max(axis=(1, 2))
            log(f"mel {rung} {name}: kernel vs plain max abs {diff:.4g}, per element {rel:.4g} "
                f"(tolerance {MEL_TOL[rung]}); vs float64 oracle max {float(err.max())!r} dB"
                + (f", kind 3 {float(err[3::4].max())!r} dB" if len(err) >= 4 else ""))
            # every reading is printed before any check of the rung fails
            if rel > MEL_TOL[rung]:
                failed.append(f"mel {rung} {name}: kernel vs plain per element {rel:.4g} <= {MEL_TOL[rung]}")
            if err.max() > adversarial_bound:
                failed.append(f"mel {rung} {name}: adversarial {err.max()!r} dB <= {adversarial_bound}")
            if set_cfg is cfg and len(clips) == 64:  # typical: kind 3 of the JAX tool's own set
                typical = float(err[3::4].max())
                log(f"mel {rung} {name}: kind-3 clips, per-clip max dB error, sorted: "
                    f"{' '.join(f'{e:.4g}' for e in np.sort(err[3::4]))}")
                if typical > typical_bound:
                    failed.append(f"mel {rung} {name}: typical {typical!r} dB <= {typical_bound}")
            max_abs, max_rel = max(max_abs, diff), max(max_rel, rel)
            adversarial = max(adversarial, float(err.max()))

        t_k = cuda_ms(lambda: mk.fused_mel_power(audio64, cfg, exact))
        t_p = cuda_ms(lambda: mk.mel_power_reference(audio64, cfg, exact))
        # least time: the products the kernel issues, or its inputs read and output written once
        w, fb, _ = mk._kernel_constants(cfg, audio64.device, rung)
        dft_p, mel_p = MEL_PRODUCTS[rung]
        flops = 4 * b * t_frames * cfg.n_fft * cfg.n_bins * dft_p + 2 * b * t_frames * cfg.n_bins * cfg.n_mels * mel_p
        nbytes = audio64.nbytes + w.nbytes + fb.nbytes + 4 * b * t_frames * cfg.n_mels
        t_flops = flops / (H100_F32_FLOPS if rung == "exact" else H100_BF16_FLOPS) * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        log(f"mel {rung}: batch {b} kernel {t_k:.3f} ms, plain {t_p:.3f} ms, torch.stft {t_lib:.3f} ms; "
            f"bound {max(t_flops, t_bytes):.4f} ms (flops {flops:.4g} → {t_flops:.4f} ms, "
            f"bytes {nbytes:.4g} → {t_bytes:.4f} ms); dB error typical {typical:.4g}, adversarial {adversarial:.4g}")
        out[rung] = {"replaces": replaces, "max_abs_err": max_abs, "max_rel_err": max_rel,
                     "max_err_db": adversarial, "typical_err_db": typical, "ms": t_k, "plain_ms": t_p,
                     "bound_ms": max(t_flops, t_bytes), "bound_by": "operations" if t_flops >= t_bytes else "bytes",
                     "library_ms": t_lib}
    check(not failed, "; ".join(failed))
    del audio64
    torch.cuda.empty_cache()
    return out


def viridis_index(rgb: np.ndarray) -> np.ndarray:
    """viridis RGB pixels → LUT indices (the lowest index where two share a colour)."""
    from spectrogramgenai_tpu_torch.audio.export import VIRIDIS_LUT

    lut = VIRIDIS_LUT.astype(np.int64)
    keys = (lut[:, 0] << 16) | (lut[:, 1] << 8) | lut[:, 2]
    order = np.argsort(keys, kind="stable")
    px = rgb.astype(np.int64)
    pos = np.searchsorted(keys[order], (px[..., 0] << 16) | (px[..., 1] << 8) | px[..., 2])
    check(bool((keys[order][np.minimum(pos, 255)] == ((px[..., 0] << 16) | (px[..., 1] << 8) | px[..., 2])).all()),
          "PNG pixels are viridis colours")
    return order[pos]


def make_corpus(work: str) -> tuple[str, str, list[dict], int]:
    """Synthetic field recordings: 32 of 60 s at 22,050 Hz and 2 at 48 kHz,
    int16, each with 8 detections of 3 s (bird-like chirps over wind noise).
    Returns the manifest, the WAV folder, the rows and the number of batches
    of 64 that gen_specs makes of them (one sample rate per batch)."""
    from scipy.io import wavfile

    wav_dir = os.path.join(work, "wavs")
    os.makedirs(wav_dir)
    rng = np.random.default_rng(0)
    rows, per_rate = [], {}
    for i, sr in enumerate([22050] * 32 + [48000] * 2):
        t = np.arange(60 * sr) / sr
        x = 0.02 * rng.standard_normal(len(t))
        for k in range(8):
            begin = 7 * k + int(rng.integers(0, 3))
            f0, f1 = rng.uniform(1500, 4000), rng.uniform(4000, 9000)
            seg = (t >= begin) & (t < begin + 3)
            ts = t[seg] - begin
            x[seg] += 0.4 * np.sin(2 * np.pi * (f0 * ts + (f1 - f0) * ts**2 / 6)) * np.sin(np.pi * ts / 3) ** 2
            rows.append({"file_name": f"rec{i:02d}.wav", "begin_time": begin, "end_time": begin + 3,
                         "common_name": f"bird{i % 5}"})
            per_rate[sr] = per_rate.get(sr, 0) + 1
        wavfile.write(os.path.join(wav_dir, f"rec{i:02d}.wav"), sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))
    manifest = os.path.join(work, "manifest.csv")
    with open(manifest, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return manifest, wav_dir, rows, sum(-(-count // 64) for count in per_rate.values())


def phase_gen_specs(torch, work: str) -> dict[str, int]:
    """cli.gen_specs.run on the card once per rung; returns each rung's launches."""
    from spectrogramgenai_tpu_torch.audio.export import spec_png_name
    from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig, reference_logmel_np
    from spectrogramgenai_tpu_torch.audio.wavio import load_wav, slice_clip
    from spectrogramgenai_tpu_torch.cli import gen_specs
    from spectrogramgenai_tpu_torch.ops.mel_kernel import fused_mel_power

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_mel_helpers import RUNG_BOUNDS

    t0 = time.perf_counter()
    manifest, wav_dir, rows, batches = make_corpus(work)
    names = [spec_png_name(r["file_name"], r["begin_time"]) for r in rows]
    log(f"gen_specs: corpus of {len(rows)} detections in {len(set(r['file_name'] for r in rows))} recordings "
        f"made in {time.perf_counter() - t0:.2f} s; {batches} batches of ≤ 64 by sample rate")

    launches, indices = {}, {}
    for exact, rung, _ in MEL_RUNGS:
        out_dir = os.path.join(work, f"images_{rung}")
        printed = io.StringIO()
        fused_mel_power.launches = 0  # the main path starts here
        t_run = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            n_done = gen_specs.run(manifest, wav_dir, out_dir, batch_size=64, save_npy=True, exact=exact,
                                   device="cuda")
        wall = time.perf_counter() - t_run
        launches[rung] = fused_mel_power.launches  # the main path ends here
        for line in printed.getvalue().splitlines():
            log(f"gen_specs {rung}: {line}")
        split = re.search(r"decode ([\d.]+) s, mel kernel ([\d.]+) s, dB glue ([\d.]+) s \(CUDA events, "
                          r"(\d+) batches\), encode ([\d.]+) s", printed.getvalue())
        check(split is not None, "gen_specs printed its time split")
        check(n_done == len(rows), f"gen_specs {rung} wrote {n_done} of {len(rows)} spectrograms")
        check(int(split.group(4)) == batches, f"gen_specs {rung} flushed {split.group(4)} batches, {batches} expected")
        check(launches[rung] >= batches, f"gen_specs {rung}: mel kernel launches {launches[rung]} >= {batches}")
        rgb = []
        for name in names:
            with open(os.path.join(out_dir, name), "rb") as f:
                rgb.append(png_rgb(f.read()))
            check(rgb[-1].shape == (256, 256, 3), f"{name} inflates to 256×256×3")
        indices[rung] = np.stack([viridis_index(x) for x in rgb])
        log(f"gen_specs {rung}: {n_done} specs in {wall:.3f} s wall → {n_done / wall:.1f} specs/s end to end; "
            f"decode {split.group(1)} s, mel kernel {split.group(2)} s, dB glue {split.group(3)} s, "
            f"encode {split.group(5)} s; "
            f"{launches[rung]} launches")

    # the exact rung's arrays against the float64 oracle
    worst = 0.0
    for row, name in zip(rows, names):
        wav, sr = load_wav(os.path.join(wav_dir, row["file_name"]))
        want = reference_logmel_np(slice_clip(wav, sr, row["begin_time"], row["end_time"]),
                                   SpectrogramConfig(sample_rate=sr))
        got = np.load(os.path.join(work, "images_exact", name.replace(".png", ".npy")))
        worst = max(worst, float(np.abs(got - want).max()))
    check(worst <= RUNG_BOUNDS[True][0],
          f"gen_specs exact .npy vs oracle {worst:.3g} dB <= {RUNG_BOUNDS[True][0]}")
    high_levels = int(np.abs(indices["exact"] - indices["high"]).max())
    fast_levels = int(np.abs(indices["exact"] - indices["fast"]).max())
    check(high_levels <= 2, f"exact and high PNGs within 2 levels ({high_levels})")
    log(f"gen_specs: exact .npy vs float64 oracle max {worst:.3g} dB; PNG levels exact vs high ≤ {high_levels}, "
        f"exact vs fast ≤ {fast_levels}")
    return launches


def phase_serve(torch, work: str) -> int:
    from spectrogramgenai_tpu_torch.cli import serve
    from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager
    from spectrogramgenai_tpu_torch.core.config import DDPMConfig, RunConfig
    from spectrogramgenai_tpu_torch.models.unet import ConditionalUNet
    from spectrogramgenai_tpu_torch.models.vqvae import VQVAE
    from spectrogramgenai_tpu_torch.ops.attention import fused_attention
    from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask

    os.chdir(work)  # checkpoints under <work>/models/…, as the CLIs expect
    cfg = DDPMConfig(run=RunConfig(run_name="smoke_ddpm", seed=0), vqae_ckpt="models/smoke_vq")
    latent = cfg.img_size // cfg.latent_downscale

    def make_unet(fused: bool = False) -> ConditionalUNet:
        return ConditionalUNet(c_in=cfg.latent_dim, c_out=cfg.latent_dim, num_classes=cfg.num_classes,
                               width_mult=cfg.width_mult, remove_deep_conv=cfg.remove_deep_conv,
                               fused_attention=fused)

    unet = make_unet()
    unet.reset_parameters(torch.Generator().manual_seed(0))
    vq = VQVAE(hidden_dim=cfg.vq_hidden_dim, n_embeddings=cfg.vq_n_embeddings)
    vq.reset_parameters(torch.Generator().manual_seed(1))
    n_params = sum(p.numel() for p in unet.parameters())
    log(f"serve: UNet {n_params / 1e6:.2f} M params (width {cfg.width_mult}, {cfg.num_classes} classes, "
        f"{latent}×{latent}×{cfg.latent_dim} latent); VQ-VAE hidden {cfg.vq_hidden_dim}, "
        f"{cfg.vq_n_embeddings} codes; compute {cfg.compute_dtype}")
    check(22e6 < n_params < 25e6, "reference-width UNet (~23.3 M params)")
    CheckpointManager(f"models/{cfg.run.run_name}").save(0, {"params": unet.state_dict(),
                                                            "ema_params": unet.state_dict()})
    CheckpointManager(cfg.vqae_ckpt).save(0, {"params": vq.state_dict()})

    # reference on a small input: the kernel route against the plain route, f32, same weights
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(2, latent, latent, cfg.latent_dim, device="cuda", generator=g)
    t, y, m = (torch.tensor([999.0, 10.0], device="cuda"), torch.tensor([3, 26], device="cuda"),
               torch.tensor([1.0, 0.0], device="cuda"))
    with torch.inference_mode():
        outs = []
        for fused in (True, False):
            net = make_unet(fused)
            net.load_state_dict(unet.state_dict())
            outs.append(net.cuda()(x, t, y, m))
        err = (outs[0] - outs[1]).abs().max().item()
    check(bool(torch.isfinite(outs[0]).all()) and err <= 1e-3,
          f"full-width UNet f32, kernel vs plain route: max abs err {err} <= 1e-3")
    log(f"serve: full-width UNet forward (batch 2, f32) kernel route vs plain route: max abs err {err:.3g}")
    del outs, net

    # every chain's output (the latents before the clamp) must be finite
    latent_finite = []
    decode = DiffusionTask.decode

    def checked_decode(self, z):
        latent_finite.append(bool(torch.isfinite(z).all()))
        return decode(self, z)

    DiffusionTask.decode = checked_decode

    fused_attention.launches = 0  # the main path starts here
    t_start = time.perf_counter()
    server, batcher = serve.run(cfg, port=0, serve_batch=SERVE_BATCH, max_delay_ms=50.0,
                                sampler="dpmpp", num_steps=NUM_STEPS,
                                class_names=[f"class{i:02d}" for i in range(cfg.num_classes)],
                                block=False, device="cuda")
    try:
        log(f"serve: up after {time.perf_counter() - t_start:.2f} s (build, load, one warmup chain)")
        base = f"http://127.0.0.1:{server.port}"
        warm = batcher.snapshot_stats()
        results: dict[int, tuple[int, dict]] = {}

        def post(i, payload):
            req = urllib.request.Request(f"{base}/generate", data=json.dumps(payload).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                results[i] = (r.status, json.loads(r.read()))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i, p)) for i, p in enumerate(REQUESTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        check(all(not th.is_alive() for th in threads), "all requests answered")
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = (r.status, json.loads(r.read()))
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
            stats = json.loads(r.read())
        launches = fused_attention.launches  # the main path ends here
    finally:
        server.shutdown()
        batcher.close()
        DiffusionTask.decode = decode

    for i, p in enumerate(REQUESTS):
        status, body = results[i]
        check(status == 200, f"request {p} → {status}")
        check(len(body["images"]) == p["count"], f"request {p} → {len(body['images'])} images")
        for img in body["images"]:
            check(png_rgb(base64.b64decode(img)).shape == (256, 256, 3), "PNG inflates to 256×256×3")
    check(health[0] == 200 and health[1]["ok"] and health[1]["backend"] == "cuda", f"healthz {health}")
    n_images = sum(p["count"] for p in REQUESTS)
    batches = stats["batches"] - warm["batches"]
    check(stats["images"] - warm["images"] == n_images, f"stats count {n_images} images")
    check(batches >= 2, f"{n_images} images ran as {batches} batches (≥ 2)")
    check(len(latent_finite) == stats["batches"] and all(latent_finite), "latents before the clamp finite")
    want = len(SA_SITES) * NUM_STEPS * stats["batches"]
    check(launches >= want, f"attention kernel launches {launches} >= 3 sites × {NUM_STEPS} steps × "
                            f"{stats['batches']} batches = {want}")
    per_batch = (stats["busy_seconds"] - warm["busy_seconds"]) / batches
    log(f"serve: {n_images} images in {batches} batches + 1 warmup, {wall:.3f} s wall; "
        f"{per_batch:.3f} s per batch (dpmpp-{NUM_STEPS}, serve batch {SERVE_BATCH}) → "
        f"{SERVE_BATCH / per_batch:.2f} images/s at full batch, {n_images / wall:.2f} images/s served")
    log(f"serve: stats {json.dumps(stats)}")
    log(f"serve: attention kernel launches {launches} (≥ {want})")

    model = batcher.task.model
    xb = torch.randn(2 * SERVE_BATCH, latent, latent, cfg.latent_dim, device="cuda", generator=g)
    tb = torch.full((2 * SERVE_BATCH,), 500.0, device="cuda")
    yb = torch.randint(0, cfg.num_classes, (2 * SERVE_BATCH,), device="cuda", generator=g)
    mb = torch.ones(2 * SERVE_BATCH, device="cuda")
    with torch.inference_mode():
        # back to back, as the sampler's steps run: one forward alone waits on
        # the host, which takes about as long to enqueue it as the card to run it
        t_unet = cuda_ms(lambda: model(xb, tb, yb, mb), runs=5, inner=10)
    log(f"serve: UNet forward at batch {2 * SERVE_BATCH} ({cfg.compute_dtype}, kernel route, 10 back to back): "
        f"{t_unet:.3f} ms; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import spectrogramgenai_tpu_torch.ops.attention as attn
    from spectrogramgenai_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build(KERNEL_SOURCES)  # one nvcc per source, started together
    log(f"build: {', '.join(KERNEL_SOURCES)} built and loaded in {time.perf_counter() - t0:.2f} s")
    for name in KERNEL_SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"build {name}: {line.strip()}")

    kern = phase_kernel(torch, attn)
    mel = phase_mel(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        launches = phase_serve(torch, work)
        os.chdir(REPO)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_specs_") as work:
        mel_launches = phase_gen_specs(torch, work)

    kernels = [{"name": "attention_fwd", "route": "cuda",
                "source": "spectrogramgenai_tpu_torch/csrc/attention_fwd.cu",
                "replaces": "spectrogramgenai_tpu/ops/attention.py:83", "launches": launches, **kern}]
    for _, rung, _ in MEL_RUNGS:
        kernels.append({"name": f"mel_power_{rung}", "route": "cuda",
                        "source": "spectrogramgenai_tpu_torch/csrc/mel_power.cu",
                        "launches": mel_launches[rung], **mel[rung]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
