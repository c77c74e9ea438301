#!/usr/bin/env python3
"""Drive the PyTorch port's serving path, mel front end and training loop once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught and passed over):

  1. device   — CUDA must be available; prints the card's name and power limit
                (nvidia-smi).
  2. build    — compiles csrc/attention_fwd.cu, csrc/attention_bwd.cu and
                csrc/mel_power.cu with nvcc from this checkout, one nvcc per
                source, started together; prints each kernel's registers and
                spills.
  3. kernel   — the attention kernels against their plain PyTorch version at
                the UNet's three fused sites (B·H = 216 = serve batch 27 × CFG
                2 × 4 heads): f32 (the scalar kernel) ≤ 1e-4 with TF32 off,
                bf16 (the tensor-core kernel, which must take every bf16
                site) ≤ 1e-2 against the f32 upcast of the same inputs, the
                residuals that training saves (row log-sum-exp, f32 output)
                against the plain version's, a large-logit row, and the
                other head dims 2, 4, 8, 64; kernel (with and without
                residuals), plain and scaled_dot_product_attention times
                (CUDA events, median), the bound and the exponentials' floor.
  4. mel      — each mel kernel rung (exact, high, fast) against its plain
                version (per element, down to 80 dB under each clip's max)
                and the float64 oracle on the stress clips of
                tools/mel_precision_bench.py (its own 64 at 22,050 Hz, 4 clips
                at 48 kHz, 5 of odd length), within each rung's dB bounds
                (tests/torch_mel_helpers.py; typical: kind 3 of the tool's 64;
                adversarial: every clip); kernel, plain and torch.stft +
                filterbank times at batch 64. The exact rung is a float64
                FFT; its bound is reckoned from the FFT's work.
  5. serve    — the full-width latent DDPM (UNet width 1.0, 27 classes,
                64×64×4 latent; VQ-VAE hidden 512, 512 codes) with seeded
                random weights, saved as checkpoints and served through
                cli.serve.run (DPM-Solver++ 20 steps, serve batch 27);
                concurrent POST /generate requests for 32 images, /healthz and
                /stats; every batch must have gone through the tensor-core
                attention kernel. One served batch's device time by kernel
                (torch.profiler).
  6. gen_specs — a synthetic corpus (32 recordings of 60 s at 22,050 Hz and 2
                at 48 kHz, 8 detections each) through cli.gen_specs.run on the
                card, once per rung: every PNG written and 256×256×3, the
                exact .npy arrays at the exact rung's bound against the oracle,
                exact and high PNGs within 2 levels, a kernel launch per batch;
                specs/s and the decode / mel kernel / dB glue / encode split.
  7. attention_bwd — the backward kernels against their plain version and
                both against float64, per row (dQ by query row, dK and dV by
                key row, each normalised by its own norm), at the training
                sites (B·H = 128 = batch 32 × 4 heads): f32 (the scalar
                kernels) with TF32 off, bf16 (the tensor-core kernels, given
                the forward's residuals) against the f64 of the same bf16
                inputs, a large-logit head and an underflow row; kernel
                (given the residuals), plain and scaled_dot_product_attention
                backward (fwd+bwd − fwd) times, the bound and the
                exponentials' floor.
  8. train_vqvae — a 27-class corpus (10 train + 6 val clips per class)
                through cli.gen_specs.run (exact rung) into datasets/{train,val}/;
                cli.train_vqvae.run with the VQVAEConfig defaults (hidden 512,
                512 codes, latent 4, 256×256, bf16, batch 16, Adam 2e-4) for 2
                epochs, then one resumed epoch: every loss finite, perplexity
                > 1, codebook and params moved, the saved step, params,
                codebook and Adam moments restored bit-equal; s/step, images/s,
                a step's split (CUDA events), its device time by kernel
                (torch.profiler) and peak memory.
  9. train    — cli.train_ddpm.run from that VQ-VAE checkpoint with the
                DDPMConfig defaults (UNet width
                1.0, 64×64×4 latent, bf16, latent cache, batch 32) for 2
                epochs of 8 steps, then again with 3 epochs, resuming; every
                loss finite, params changed, both attention kernels launched
                at 3 sites per step (the forward on its tensor-core route), the checkpoint served through
                cli.common.load_task (one dpmpp-20 batch). One full-width step
                through the kernels against the plain attention (same t,
                noise, keep); images/s, s/step, a step's split (CUDA events),
                the attention share of a step's device time (torch.profiler),
                peak memory and the latent-cache encode time.
 10. classifiers — cli.generate.run writes 3 dpmpp-20 images per class from
                the trained DDPM ({class}_gen_imgs_{i}_{samp}.png);
                cli.train_classifiers runs the custom CNN and ResNet18 at 0 and
                2 synthetic images per class for 2 epochs (batch 16, 256×256,
                val standing in as test): finite losses, a CSV row per epoch,
                the best checkpoint, the synthetic count per class, ResNet18's
                frozen prefix bit-equal to its init with its BatchNorm
                statistics moved; one train step each of VGG16, MobileNetV2 and
                the ensemble; cli.eval_classifiers on the best checkpoints;
                s/epoch, images/s, step times and peak memory.

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
KERNEL_SOURCES = ("attention_fwd", "attention_bwd", "mel_power")
TRAIN_BATCH = 32
TRAIN_BH = TRAIN_BATCH * 4  # no CFG doubling in training
TRAIN_CLASSES, TRAIN_PER_CLASS, VAL_PER_CLASS = 27, 10, 6  # docs/EXPERIMENT.md's split sizes
# the backward kernel against float64, per row: each tolerance sits just
# above the plain version's own reading at these shapes (PERF.md §6, PR 3)
# (plain readings, NVIDIA H100: f32 ≤ 4.4e-6, bf16 ≤ 3.24e-3, the output rounding)
BWD_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
# logits up to ~150 leave ~|s|·2⁻²⁴·√d of f32 rounding in the logits
# themselves (plain readings: f32 ≤ 3.64e-4, bf16 ≤ 3.24e-3)
LARGE_LOGIT_TOL = {"float32": 5e-4, "bfloat16": 5e-3}
# one full-width bf16 train step, kernels against the plain attention route:
# bf16 rounding at other places in the two routes (readings on the card: loss
# 9.1e-5 relative, per-tensor gradient 6.3e-3 at most, median 2.0e-3)
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-3, 2e-2
# H100 SXM peaks (NVIDIA's data sheet): memory rate, bf16 tensor cores, and the
# float64 rate outside the tensor cores (half the scalar float32 rate of 67)
H100_BYTES_PER_S, H100_BF16_FLOPS, H100_F64_FLOPS = 3.35e12, 989e12, 34e12
# exponentials: MUFU issues 16 a clock per SM, ~4.2e12/s over 132 SMs
H100_EXP_PER_S = 4.2e12
MEL_RUNGS = ((True, "exact", "spectrogramgenai_tpu/ops/mel_kernel.py:94"),
             ("high", "high", "spectrogramgenai_tpu/ops/mel_kernel.py:147"),
             (False, "fast", "spectrogramgenai_tpu/ops/mel_kernel.py:94"))
# (bf16 products of the DFT, of the filterbank product) of the tensor-core rungs
MEL_PRODUCTS = {"high": (3, 3), "fast": (1, 1)}


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

    max_err, ms, res_ms, plain_ms, library_ms, flops_ms, bytes_ms, exp_ms = (0.0,) * 8
    for name, n, d in SA_SITES:
        q, k, v = rand(n, d, torch.float32)
        err32 = (fused(q, k, v) - ref(q, k, v)).abs().max().item()
        torch.cuda.synchronize()
        check(err32 <= 1e-4, f"{name} f32 max abs err {err32} <= 1e-4")

        qb, kb, vb = (t.bfloat16() for t in (q, k, v))
        mma_before = fused.mma_launches
        out = fused(qb, kb, vb)
        check(out.dtype == torch.bfloat16, "bf16 output dtype")
        check(fused.mma_launches == mma_before + 1, f"{name} bf16 ran the tensor-core kernel")
        err16 = (out.float() - ref(qb.float(), kb.float(), vb.float())).abs().max().item()
        check(err16 <= 1e-2, f"{name} bf16 max abs err {err16} <= 1e-2")
        # the residuals of training (bf16): the row log-sum-exp to f32 rounding
        # of its logits, the f32 output to f32 sums in another order
        out_r, lse, o32 = attn.fused_attention_residuals(qb, kb, vb)
        _, lse_p, o32_p = ref(qb, kb, vb, residuals=True)
        err_lse, err_o32 = (lse - lse_p).abs().max().item(), (o32 - o32_p).abs().max().item()
        check(err_lse <= 1e-4 and err_o32 <= 1e-4 and bool((o32.bfloat16() == out_r).all()),
              f"{name} residuals: lse {err_lse:.3g}, o32 {err_o32:.3g} <= 1e-4; out is o32 rounded")
        del out_r, lse, o32, lse_p, o32_p

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
        t_res = cuda_ms(lambda: attn.fused_attention_residuals(qb, kb, vb))
        t_p = cuda_ms(lambda: ref(qb, kb, vb))
        t_k32 = cuda_ms(lambda: fused(q, k, v))
        t_p32 = cuda_ms(lambda: ref(q, k, v))
        t_lib = cuda_ms(lambda: sdpa(qb, kb, vb))
        # least time for the bf16 work: q·kᵀ and p·v on the tensor cores, or
        # q, k, v read and o written once; the exponentials (MUFU, 16 per
        # clock per SM), one per pair, are the floor beside them
        flops, nbytes, exps = 4 * BH * n * n * d, 4 * BH * n * d * 2, BH * n * n
        t_flops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        t_exp = exps / H100_EXP_PER_S * 1e3
        log(f"kernel {name} (B·H={BH}, N={n}, d={d}): err f32 {err32:.3g} bf16 {err16:.3g} "
            f"residuals lse {err_lse:.3g} o32 {err_o32:.3g} "
            f"large-logit vs f64: f32 {errl:.3g} (plain f32 {errl_plain:.3g}), bf16(rel) {errlb:.3g} | "
            f"bf16 kernel {t_k:.3f} ms (with residuals {t_res:.3f} ms), plain {t_p:.3f} ms, "
            f"scaled_dot_product_attention {t_lib:.3f} ms | "
            f"f32 kernel {t_k32:.3f} ms, plain {t_p32:.3f} ms | bound {max(t_flops, t_bytes):.4f} ms "
            f"(tensor-core flops {t_flops:.4f}, bytes {t_bytes:.4f}); exponentials' floor {t_exp:.4f} ms "
            f"({exps:.3g} at {H100_EXP_PER_S:.2g}/s)")
        max_err = max(max_err, err32, err16)
        ms += t_k
        res_ms += t_res
        plain_ms += t_p
        library_ms += t_lib
        flops_ms += t_flops
        bytes_ms += t_bytes
        exp_ms += t_exp
        del q, k, v, qb, kb, vb, out, ql, ks, vs, big, exact, qlb, ksb, vsb, want
        torch.cuda.empty_cache()

    # the other compiled head dims (narrow widths, as in tests/test_torch_cuda.py):
    # bf16 at d = 64 on the tensor cores, the rest on the scalar kernel
    for d in (2, 4, 8, 64):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            q, k, v = rand(1024, d, dtype)
            mma_before = fused.mma_launches
            err = (fused(q, k, v).float() - ref(q.float(), k.float(), v.float())).abs().max().item()
            check(err <= tol, f"d={d} {dtype} max abs err {err} <= {tol}")
            want_mma = 1 if attn.tensor_core_route(dtype, d) else 0
            check(fused.mma_launches == mma_before + want_mma, f"d={d} {dtype} took its route")
            if dtype == torch.bfloat16:
                _, lse, o32 = attn.fused_attention_residuals(q, k, v)
                _, lse_p, o32_p = ref(q, k, v, residuals=True)
                err_r = max((lse - lse_p).abs().max().item(), (o32 - o32_p).abs().max().item())
                check(err_r <= 1e-4, f"d={d} bf16 residuals {err_r:.3g} <= 1e-4")
    torch.cuda.synchronize()
    bound_ms = max(flops_ms, bytes_ms)
    log(f"kernel: head dims 2, 4, 8, 64 match in f32 and bf16; three-site sum bf16 kernel {ms:.3f} ms "
        f"(with residuals {res_ms:.3f} ms), plain {plain_ms:.3f} ms, scaled_dot_product_attention "
        f"{library_ms:.3f} ms, bound {bound_ms:.4f} ms, exponentials' floor {exp_ms:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes", "library_ms": library_ms,
            "residuals_ms": res_ms}


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
        # least time: the operations of the kernel's algorithm, or its inputs
        # and constants read and output written once
        consts = [c for c in mk._kernel_constants(cfg, audio64.device, rung) if isinstance(c, torch.Tensor)]
        nbytes = audio64.nbytes + sum(c.nbytes for c in consts) + 4 * b * t_frames * cfg.n_mels
        if rung == "exact":  # the FFT: one complex transform per pair of frames, in float64
            flops = fft_mel_flops(b, t_frames, cfg.n_fft, int(consts[2][:, 1].sum().item()))
            t_flops = flops / H100_F64_FLOPS * 1e3
        else:  # the DFT and filterbank products on the bf16 tensor cores
            dft_p, mel_p = MEL_PRODUCTS[rung]
            flops = (4 * b * t_frames * cfg.n_fft * cfg.n_bins * dft_p
                     + 2 * b * t_frames * cfg.n_bins * cfg.n_mels * mel_p)
            t_flops = flops / H100_BF16_FLOPS * 1e3
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


def fft_mel_flops(b: int, t_frames: int, n_fft: int, nnz: int) -> int:
    """float64 operations of the exact rung for b clips of t_frames frames: per
    pair of frames the window (2 per sample), one complex FFT (5·N·log2 N),
    the two spectra's split and power (14 per bin); per frame 2 per nonzero
    filterbank weight."""
    pairs = b * -(-t_frames // 2)
    per_pair = 2 * n_fft + 5 * n_fft * int(math.log2(n_fft)) + 14 * (n_fft // 2 + 1)
    return pairs * per_pair + 2 * b * t_frames * nnz


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

    fused_attention.launches = fused_attention.mma_launches = 0  # the main path starts here
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
        launches, mma_launches = fused_attention.launches, fused_attention.mma_launches  # the main path ends here
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
    check(mma_launches == launches, f"every served attention launch on the tensor-core route "
                                    f"({mma_launches} of {launches})")
    per_batch = (stats["busy_seconds"] - warm["busy_seconds"]) / batches
    log(f"serve: {n_images} images in {batches} batches + 1 warmup, {wall:.3f} s wall; "
        f"{per_batch:.3f} s per batch (dpmpp-{NUM_STEPS}, serve batch {SERVE_BATCH}) → "
        f"{SERVE_BATCH / per_batch:.2f} images/s at full batch, {n_images / wall:.2f} images/s served")
    log(f"serve: stats {json.dumps(stats)}")
    log(f"serve: attention kernel launches {launches} (≥ {want}), {mma_launches} on the tensor-core route")

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

    # one served batch's device time by kernel: dpmpp-20 at serve batch 27
    labels = torch.arange(SERVE_BATCH) % cfg.num_classes
    gen_s = torch.Generator(device="cuda").manual_seed(4)
    what = "serve: one batch (dpmpp-20, serve batch 27)"
    check_fwd_route_in_profile(what, log_profile(torch, what, lambda: batcher.task.sample(
        labels, generator=gen_s, sampler="dpmpp", num_steps=NUM_STEPS)))
    return launches


def row_rel_err(got, want) -> float:
    """max over rows of |got − want| / |want|, norms over the head dim."""
    got, want = got.double(), want.double()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


def exact_bwd64(q, k, v, do):
    """(dq, dk, dv) of softmax(q·kᵀ/√d)·v computed in float64."""
    import torch

    q, k, v, do = q.double(), k.double(), v.double(), do.double()
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(q @ k.mT * scale, dim=-1)
    dp = do @ v.mT
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return ds @ k * scale, ds.mT @ q * scale, p.mT @ do


def phase_attention_bwd(torch, attn) -> dict:
    """The backward kernel at the training sites against its plain version and float64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    ref, bwd = attn.attention_bwd_reference, attn.fused_attention_bwd
    sdpa = torch.nn.functional.scaled_dot_product_attention  # the yardstick; the port never calls it
    heads64 = 16  # heads held to float64 (its (N, N) matrices at N = 4096 take 2 GB each)

    failed, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    ms = plain_ms = library_ms = flops_ms = bytes_ms = exp_ms = 0.0

    def residuals(q, k, v, do):
        """The forward's residuals that the bf16 backward takes; none for f32."""
        return attn.fused_attention_residuals(q, k, v)[1:] if q.dtype == torch.bfloat16 else ()

    for name, n, d in SA_SITES:
        q, k, v, do = (torch.randn(1, TRAIN_BH, n, d, device="cuda", generator=gen) for _ in range(4))
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[-1]
            args = [t.to(dtype) for t in (q, k, v, do)]
            got = bwd(*args, *residuals(*args))
            want = ref(*args)
            torch.cuda.synchronize()
            exact = exact_bwd64(*(t[:, :heads64] for t in args))
            errs = []
            for label, g, w, e in zip(("dq", "dk", "dv"), got, want, exact):
                check(g.dtype == dtype and g.shape == q.shape, f"{name} {key} {label} dtype and shape")
                check(bool(torch.isfinite(g).all()), f"{name} {key} {label} finite")
                k_err, p_err = row_rel_err(g[:, :heads64], e), row_rel_err(w[:, :heads64], e)
                kp_err = row_rel_err(g, w)
                errs.append(f"{label} kernel {k_err:.3g} plain {p_err:.3g} kernel-vs-plain {kp_err:.3g}")
                worst[key] = max(worst[key], k_err)
                if k_err > BWD_TOL[key]:
                    failed.append(f"{name} {key} {label}: kernel vs float64 per row {k_err:.3g} <= {BWD_TOL[key]}")
            log(f"attention_bwd {name} (B·H={TRAIN_BH}, N={n}, d={d}) {key}, per-row error vs float64: "
                + "; ".join(errs))
            del got, want, exact

        # a large-logit head (logits up to ~165: past exp's f32 range) and an underflow row
        ql, kl, vl, dol = (t[:, :4].clone() for t in (q, k, v, do))
        kl[..., 0] += 200.0
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[-1]
            args = [t.to(dtype) for t in (ql, kl, vl, dol)]
            got = bwd(*args, *residuals(*args))
            for label, g, w, e in zip(("dq", "dk", "dv"), got, ref(*args), exact_bwd64(*args)):
                k_err, p_err = row_rel_err(g, e), row_rel_err(w, e)
                log(f"attention_bwd {name} large logits {key} {label}: kernel {k_err:.3g}, plain {p_err:.3g}")
                check(bool(torch.isfinite(g).all()), f"{name} large-logit {key} {label} finite")
                if k_err > LARGE_LOGIT_TOL[key]:
                    failed.append(f"{name} large-logit {key} {label}: {k_err:.3g} <= {LARGE_LOGIT_TOL[key]}")
        # every logit −10⁴·√d: an unshifted exp gives 0/0. P is uniform and dP
        # constant along the row, so dS, dQ and dK are 0 up to the rounding of
        # dP − c (a sum over N alike terms) carried by |k| = |q| = 100: 1.5e-3
        # at N = 4096, where a dS that did not cancel would give ~50. dV is
        # the mean of dO
        qu = torch.full((1, 1, n, d), 100.0, device="cuda")
        ku = torch.full((1, 1, n, d), -100.0, device="cuda")
        dou = dol[:, :1].contiguous()
        dq, dk, dv = bwd(qu, ku, torch.ones_like(qu), dou)
        check(all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv)), f"{name} underflow row: no NaN")
        u_dq, u_dk = dq.abs().max().item(), dk.abs().max().item()
        u_dv = (dv - dou.mean(dim=2, keepdim=True)).abs().max().item()
        log(f"attention_bwd {name} underflow rows (f32): |dQ| {u_dq:.3g}, |dK| {u_dk:.3g}, |dV − mean dO| {u_dv:.3g}")
        check(max(u_dq, u_dk) <= 1e-2 and u_dv <= 1e-5, f"{name} underflow rows: dQ = dK = 0, dV = mean of dO")

        qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
        lse, o32 = residuals(qb, kb, vb, dob)
        t_k = cuda_ms(lambda: bwd(qb, kb, vb, dob, lse, o32))  # the backward alone, given the residuals
        t_p = cuda_ms(lambda: ref(qb, kb, vb, dob), runs=5)
        qs, ks, vs = (t.detach().requires_grad_() for t in (qb, kb, vb))
        t_fwd = cuda_ms(lambda: sdpa(qs, ks, vs))
        t_both = cuda_ms(lambda: torch.autograd.grad(sdpa(qs, ks, vs), (qs, ks, vs), dob))
        t_lib = t_both - t_fwd
        # least time for the bf16 work: five N×N×d products (S, dV, dP, dQ, dK)
        # on the tensor cores, or q, k, v, dO, lse and O₃₂ read and dq, dk, dv
        # written once; beside it the floor of the exponentials (P once in
        # each of the two kernels, MUFU)
        flops, exps = 10 * TRAIN_BH * n * n * d, 2 * TRAIN_BH * n * n
        nbytes = 7 * TRAIN_BH * n * d * 2 + TRAIN_BH * n * 4 + TRAIN_BH * n * d * 4
        t_flops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        t_exp = exps / H100_EXP_PER_S * 1e3
        log(f"attention_bwd {name}: bf16 kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
            f"scaled_dot_product_attention backward {t_lib:.3f} ms (fwd+bwd {t_both:.3f} − fwd {t_fwd:.3f}) | "
            f"bound {max(t_flops, t_bytes):.4f} ms (tensor-core flops {t_flops:.4f}, bytes {t_bytes:.4f}); "
            f"exponentials' floor {t_exp:.4f} ms ({exps:.3g} at {H100_EXP_PER_S:.2g}/s)")
        ms, plain_ms, library_ms = ms + t_k, plain_ms + t_p, library_ms + t_lib
        flops_ms, bytes_ms, exp_ms = flops_ms + t_flops, bytes_ms + t_bytes, exp_ms + t_exp
        del q, k, v, do, qb, kb, vb, dob, qs, ks, vs, lse, o32
        torch.cuda.empty_cache()

    check(not failed, "; ".join(failed))
    bound_ms = max(flops_ms, bytes_ms)
    log(f"attention_bwd: three-site sum bf16 kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"scaled_dot_product_attention backward {library_ms:.3f} ms, bound {bound_ms:.4f} ms, "
        f"exponentials' floor {exp_ms:.4f} ms; "
        f"worst kernel error vs float64 per row f32 {worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g}")
    return {"max_abs_err": max(worst.values()), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes", "library_ms": library_ms}


def make_class_corpus(work: str) -> tuple[str, str, list[dict]]:
    """27 synthetic recordings of 60 s at 22,050 Hz, one class each, with 16
    detections of 3 s: a chirp in a class-dependent band over wind noise."""
    from scipy.io import wavfile

    wav_dir = os.path.join(work, "wavs")
    os.makedirs(wav_dir)
    rng = np.random.default_rng(1)
    sr, rows = 22050, []
    for c in range(TRAIN_CLASSES):
        t = np.arange(60 * sr) / sr
        x = 0.02 * rng.standard_normal(len(t))
        for j in range(TRAIN_PER_CLASS + VAL_PER_CLASS):
            begin = 3.5 * j + float(rng.uniform(0, 0.4))
            f0 = 1000 + 250 * c + rng.uniform(-100, 100)
            seg = (t >= begin) & (t < begin + 3)
            ts = t[seg] - begin
            x[seg] += 0.4 * np.sin(2 * np.pi * (f0 * ts + 800 * ts**2 / 6)) * np.sin(np.pi * ts / 3) ** 2
            rows.append({"file_name": f"class{c:02d}.wav", "begin_time": begin, "end_time": begin + 3,
                         "common_name": f"class{c:02d}"})
        wavfile.write(os.path.join(wav_dir, f"class{c:02d}.wav"), sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))
    manifest = os.path.join(work, "manifest.csv")
    with open(manifest, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return manifest, wav_dir, rows


def run_quiet(fn, *args, **kw):
    """fn(*args, **kw) with its standard output captured; returns (result, printed text)."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = fn(*args, **kw)
    return result, printed.getvalue()


def make_train_datasets(work: str) -> None:
    """The 27-class corpus through cli.gen_specs.run (exact rung) on the card,
    split into <work>/datasets/{train,val}/<class>/; changes into <work>."""
    import shutil

    from spectrogramgenai_tpu_torch.audio.export import spec_png_name
    from spectrogramgenai_tpu_torch.cli import gen_specs

    os.chdir(work)  # datasets/, models/ and results/ under <work>, as the CLIs expect
    t0 = time.perf_counter()
    manifest, wav_dir, rows = make_class_corpus(work)
    n_specs, printed = run_quiet(gen_specs.run, manifest, wav_dir, "specs", batch_size=64, exact=True,
                                 device="cuda")
    check(n_specs == len(rows), f"gen_specs wrote {n_specs} of {len(rows)} spectrograms")
    per_class = TRAIN_PER_CLASS + VAL_PER_CLASS
    for i, row in enumerate(rows):
        split = "train" if i % per_class < TRAIN_PER_CLASS else "val"
        dst = os.path.join("datasets", split, row["common_name"])
        os.makedirs(dst, exist_ok=True)
        shutil.move(os.path.join("specs", spec_png_name(row["file_name"], row["begin_time"])), dst)
    log(f"train: corpus of {len(rows)} clips ({TRAIN_CLASSES} classes × {TRAIN_PER_CLASS} train + "
        f"{VAL_PER_CLASS} val) through cli.gen_specs.run (exact) in {time.perf_counter() - t0:.2f} s")


def phase_train_vqvae(torch, cfg=None) -> str:
    """cli.train_vqvae.run on the card for 2 epochs, then one resumed epoch;
    returns the checkpoint directory that the DDPM phase starts from."""
    import dataclasses

    from spectrogramgenai_tpu_torch.cli import train_vqvae
    from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager
    from spectrogramgenai_tpu_torch.core.config import DataConfig, RunConfig, VQVAEConfig
    from spectrogramgenai_tpu_torch.train.vqvae_task import VQVAETask

    # the VQVAEConfig defaults: hidden 512, 512 codes, latent 4, 256×256, bf16, batch 16, Adam 2e-4
    cfg = cfg or VQVAEConfig(run=RunConfig(run_name="smoke_vqvae", seed=0, log_every=1),
                             data=DataConfig(dataset_path="datasets", batch_size=16), epochs=2)
    steps_per_epoch = TRAIN_CLASSES * TRAIN_PER_CLASS // cfg.data.batch_size
    steps = 2 * steps_per_epoch
    torch.cuda.reset_peak_memory_stats()
    t_run = time.perf_counter()
    (task, state), printed = run_quiet(train_vqvae.run, cfg, device="cuda")
    wall = time.perf_counter() - t_run
    peak = torch.cuda.max_memory_allocated() / 2**30
    for line in printed.splitlines():
        log(f"train_vqvae run 1: {line}")
    check(state.step == steps, f"VQ-VAE trained {state.step} steps, {steps} expected")
    epochs = re.findall(r"epoch (\d+): (\d+) steps in ([\d.]+) s, ([\d.]+) s/step, ([\d.]+) images/s", printed)
    check(len(epochs) == 2, "two VQ-VAE epoch lines")
    records = [json.loads(line) for line in open(f"results/{cfg.run.run_name}/metrics.jsonl")]
    train = [r for r in records if "recon_mse" in r]
    check(len(train) == steps, f"{steps} logged VQ-VAE steps")
    for key in ("loss", "recon_mse", "commitment", "codebook", "perplexity"):
        check(all(math.isfinite(r[key]) for r in train), f"VQ-VAE {key} finite at every step")
    check(all(r["perplexity"] > 1.0 for r in train), "VQ-VAE perplexity > 1 at every step")
    vals = [r for r in records if "val_loss" in r]
    check(len(vals) == 2 and all(math.isfinite(r["val_loss"]) for r in vals), "two finite VQ-VAE val losses")
    check(os.path.exists(f"results/{cfg.run.run_name}/recon_epoch_001.png"), "reconstruction figure written")
    init = VQVAETask(cfg, "cpu").init_state()
    moved = sum(not torch.equal(state.params[k].cpu(), v) for k, v in init.params.items())
    check(moved >= 0.9 * len(init.params), f"VQ-VAE params changed ({moved} of {len(init.params)} tensors)")
    check(float(state.stats["codebook.ema_count"].sum()) > 0 and not torch.equal(
        state.stats["codebook.embedding"].cpu(), init.stats["codebook.embedding"]), "the codebook's EMA moved")
    log(f"train_vqvae: {steps} steps of batch {cfg.data.batch_size} (hidden {cfg.hidden_dim}, {cfg.n_embeddings} "
        f"codes, {cfg.data.img_size}×{cfg.data.img_size}, {cfg.compute_dtype}) in {wall:.2f} s wall (with "
        f"validation and figures); epoch 1 {epochs[1][3]} s/step, {epochs[1][4]} images/s (epoch 0 {epochs[0][3]} "
        f"s/step); loss {train[0]['loss']:.4f} → {train[-1]['loss']:.4f}, perplexity {train[0]['perplexity']:.2f} "
        f"→ {train[-1]['perplexity']:.2f}; peak device memory {peak:.2f} GiB")

    # resume: one more epoch from the saved step; the saved state restores exactly
    (task2, state2), printed = run_quiet(train_vqvae.run, dataclasses.replace(cfg, epochs=1), device="cuda")
    for line in printed.splitlines():
        log(f"train_vqvae run 2: {line}")
    check(f"resumed VQ-VAE from step {steps}" in printed, f"the second VQ-VAE run resumed from step {steps}")
    check(state2.step == steps + steps_per_epoch, f"resumed VQ-VAE run ended at step {state2.step}")
    ckpt = CheckpointManager(os.path.join("models", cfg.run.run_name))
    again = VQVAETask(cfg, "cuda")
    restored = again.load_state(again.init_state(seed=1), ckpt.restore(steps))
    check(restored.step == steps, "restored step")
    for name, got, want in (("params", restored.params, state.params), ("codebook", restored.stats, state.stats),
                            ("Adam moments", restored.opt_state(), state.opt_state())):
        check(set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want),
              f"the checkpoint restores the VQ-VAE's {name} exactly")
    del task, state, again, restored
    vqvae_step_split(torch, task2, state2, cfg)
    del task2, state2
    torch.cuda.empty_cache()
    return ckpt.directory


def vqvae_step_split(torch, task, state, cfg) -> None:
    """A VQ-VAE step's split (CUDA events: forward with the codebook update,
    backward, Adam) on batches already on the card, and its device time by
    kernel (torch.profiler)."""
    from spectrogramgenai_tpu_torch.data.pipeline import ImageFolderSource, iterate_batches, to_device
    from spectrogramgenai_tpu_torch.data.transforms import renorm_m1_1
    from spectrogramgenai_tpu_torch.train.common import optimizer_update

    # loaded first: a decode in the prefetch thread beside the timed step
    # holds the interpreter lock against the step's enqueue
    src = ImageFolderSource("datasets/train", seed=0, img_size=cfg.data.img_size)
    batches = [to_device(b, torch.device("cuda"))["image"]
               for b, _ in zip(iterate_batches(src, cfg.data.batch_size, epochs=None), range(7))]
    module = dict(task.model.named_parameters())
    working = [module[k] for k in state.params]
    split = {"forward": [], "backward": [], "optimizer": []}
    for i, images in enumerate(batches[:6]):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = task._losses(renorm_m1_1(images.float()), train=True)[0]
        ev[1].record()
        loss.backward()
        ev[2].record()
        optimizer_update(state.opt, list(state.params.values()), [p.grad.float() for p in working], working)
        for p in working:
            p.grad = None
        ev[3].record()
        ev[3].synchronize()
        if i >= 2:  # after warm-up
            for j, key in enumerate(split):
                split[key].append(ev[j].elapsed_time(ev[j + 1]))
    med = {k: statistics.median(v) for k, v in split.items()}
    log(f"train_vqvae: one step's split (batch {cfg.data.batch_size}, CUDA events, median of 4): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items()) + f"; sum {sum(med.values()):.3f} ms")
    log_profile(torch, "train_vqvae: one step", lambda: task.train_step(state, batches[6]))


def phase_classifiers(torch, ddpm_cfg, img_size: int = 256, batch_size: int = 16, gen_per_class: int = 3,
                      epochs: int = 2) -> None:
    """Generated images from the trained DDPM, then the classifier sweep on
    real + synthetic images and its evaluation, through the CLIs; one train
    step each of the nets the sweep does not train here."""
    import dataclasses

    from spectrogramgenai_tpu_torch.cli import eval_classifiers, generate, train_classifiers
    from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager
    from spectrogramgenai_tpu_torch.core.config import ClassifierConfig, DataConfig, RunConfig
    from spectrogramgenai_tpu_torch.data.manifest import class_names_from_folder
    from spectrogramgenai_tpu_torch.data.pipeline import ImageFolderSource, device_prefetch, iterate_batches
    from spectrogramgenai_tpu_torch.train.classifier_task import ClassifierTask

    classes = class_names_from_folder("datasets/train")
    t0 = time.perf_counter()
    _, printed = run_quiet(generate.run, ddpm_cfg, "gen_images", gen_per_class, 0, classes, sampler="dpmpp",
                           num_steps=NUM_STEPS, device="cuda")
    wall = time.perf_counter() - t0
    names = os.listdir("gen_images")
    per_class = {c: sum(bool(re.fullmatch(rf"{c}_gen_imgs_{i}_\d+\.png", n)) for n in names)
                 for i, c in enumerate(classes)}
    check(set(per_class.values()) == {gen_per_class} and len(names) == gen_per_class * len(classes),
          f"cli.generate wrote {gen_per_class} images per class under the naming contract")
    log(f"classifiers: cli.generate.run wrote {len(names)} images ({gen_per_class} per class, dpmpp-{NUM_STEPS}) "
        f"in {wall:.2f} s")

    synths = (0, 2)
    common = ["--val_dir", "datasets/val", "--test_dir", "datasets/val", "--models", "custom,resnet",
              "--synths", ",".join(map(str, synths)), "--data.img_size", str(img_size),
              "--data.batch_size", str(batch_size), "--run.output_dir", "sweep", "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results, printed = run_quiet(train_classifiers.main, ["--train_dir", "datasets/train", "--gen_dir", "gen_images",
                                                          "--epochs", str(epochs), *common])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    for line in printed.splitlines():
        log(f"classifiers sweep: {line}")
    n_real = TRAIN_CLASSES * TRAIN_PER_CLASS
    for model, synth in ((m, s) for m in ("custom", "resnet") for s in synths):
        tag = f"{model}_synth{synth}"
        if synth:
            check(f"{model} synth {synth}: added {synth * TRAIN_CLASSES} generated images to {n_real} real ones"
                  in printed, f"{tag}: {synth} synthetic images added per class")
        lines = re.findall(rf"{tag} epoch (\d+): (\d+) steps in ([\d.]+) s, ([\d.]+) images/s, "
                           r"train_loss=([\d.naif]+) val_acc=([\d.]+)", printed)
        check(len(lines) == epochs and all(math.isfinite(float(x[4])) for x in lines),
              f"{tag}: {epochs} epoch lines with finite losses")
        with open(f"sweep/{tag}/{tag}_metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        check([int(r["epoch"]) for r in rows] == list(range(epochs)), f"{tag}: one CSV row per epoch")
        best = CheckpointManager(f"sweep/ckpt_{tag}")
        check(best.best_meta() is not None and best.restore(best=True) is not None, f"{tag}: best checkpoint")
        s_epoch = float(np.mean([float(x[2]) for x in lines[1:]]))
        log(f"classifiers {tag}: {s_epoch:.3f} s/epoch (epoch 0 {lines[0][2]} s), {lines[-1][3]} images/s, "
            f"{lines[-1][1]} steps of batch {batch_size} at {img_size}×{img_size}; best val acc "
            f"{results[(model, synth)]:.4f} (epoch {best.best_meta()['step']})")
    log(f"classifiers sweep: 4 runs of {epochs} epochs in {wall:.2f} s wall; peak device memory {peak:.2f} GiB")

    # ResNet18's frozen prefix: bit-equal to its initial values; its BatchNorm statistics moved
    cfg = ClassifierConfig(run=RunConfig(run_name="classifiers", output_dir="sweep"), model_name="resnet",
                           num_classes=TRAIN_CLASSES, data=DataConfig(img_size=img_size, batch_size=batch_size))
    task = ClassifierTask(cfg, "cpu")
    init = task.init_state()
    saved = CheckpointManager("sweep/ckpt_resnet_synth2").restore(best=True)["params"]
    frozen = [k for k, flag in task.mask.items() if not flag]
    check(frozen and all(torch.equal(saved[k], init.params[k]) for k in frozen),
          f"ResNet18's {len(frozen)} frozen tensors bit-equal to their initial values")
    check(all(not torch.equal(saved[k], v) for k, v in init.stats.items()), "ResNet18's running statistics moved")
    del task, init

    # one train step each of VGG16, MobileNetV2 and the ensemble at full size
    src = ImageFolderSource("datasets/train", seed=0, img_size=img_size)
    batch = next(device_prefetch(iterate_batches(src, batch_size), torch.device("cuda")))
    for model in ("vgg", "mobilenet", "ensemble"):
        torch.cuda.reset_peak_memory_stats()
        task = ClassifierTask(dataclasses.replace(cfg, model_name=model), "cuda")
        state = task.init_state()
        before = {k: v.clone() for k, v in state.params.items()}
        times, losses = [], []
        for _ in range(3):  # the first warms up
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = task.train_step(state, batch["image"], batch["label"])
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            losses.append(float(m["train_loss"]))
        check(all(math.isfinite(x) for x in losses), f"{model}: finite train losses")
        frozen = [k for k, flag in task.mask.items() if not flag]
        check(all(torch.equal(state.params[k], before[k]) for k in frozen), f"{model}: frozen params unchanged")
        check(any(not torch.equal(state.params[k], before[k]) for k, flag in task.mask.items() if flag),
              f"{model}: trainable params moved")
        n_params = sum(v.numel() for v in state.params.values())
        log(f"classifiers {model}: one train step (batch {batch_size}, {img_size}×{img_size}, {cfg.compute_dtype}, "
            f"{n_params / 1e6:.1f} M params, {sum(task.mask.values())} of {len(task.mask)} tensors trained) "
            f"{statistics.median(times[1:]):.3f} ms (CUDA events, median of 2 after a warm-up); losses "
            + ", ".join(f"{x:.4f}" for x in losses)
            + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del task, state, before
        torch.cuda.empty_cache()

    # the best checkpoints, evaluated again through the evaluation CLI
    rows, printed = run_quiet(eval_classifiers.main, ["--out_dir", "eval", *common])
    check(len(rows) == 4, f"cli.eval_classifiers evaluated {len(rows)} of 4 best checkpoints")
    for row in rows:
        want = results[(row["model"], row["synth"])]
        check(all(math.isfinite(row[k]) for k in ("val_accuracy", "val_f1", "test_loss")), "finite eval metrics")
        check(abs(row["val_accuracy"] - want) <= 0.02, f"{row['model']}_synth{row['synth']}: the best checkpoint "
                                                        f"evaluates to {row['val_accuracy']:.4f} (kept at {want:.4f})")
        log(f"classifiers eval {row['model']}_synth{row['synth']}: val accuracy {row['val_accuracy']:.4f}, "
            f"macro F1 {row['val_f1']:.4f}, top-3 {row['val_top3_acc']:.4f}")
    check(len(os.listdir("eval")) == 5, "eval_results.csv and four classification reports")


def phase_train(torch, vqae_ckpt: str) -> tuple[tuple[int, int], object]:
    """cli.train_ddpm.run on the card from the VQ-VAE checkpoint ``vqae_ckpt``,
    resumed once; returns the forward and backward kernel launches of the
    first run (the main path) and the config."""
    import dataclasses

    from spectrogramgenai_tpu_torch.cli import train_ddpm
    from spectrogramgenai_tpu_torch.cli.common import load_task, restore
    from spectrogramgenai_tpu_torch.core.config import DataConfig, DDPMConfig, RunConfig
    from spectrogramgenai_tpu_torch.ops.attention import fused_attention, fused_attention_bwd
    from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask

    vq_params = restore(vqae_ckpt, "VQ-VAE")["params"]  # the VQ-VAE that phase_train_vqvae trained
    cfg = DDPMConfig(run=RunConfig(run_name="smoke_train", seed=0, log_every=1, ckpt_every_epochs=1),
                     data=DataConfig(dataset_path="datasets", batch_size=TRAIN_BATCH),
                     vqae_ckpt=vqae_ckpt, epochs=2, log_every_epoch=1)
    steps_per_epoch = TRAIN_CLASSES * TRAIN_PER_CLASS // cfg.data.batch_size

    torch.cuda.reset_peak_memory_stats()
    fused_attention.launches = fused_attention.mma_launches = fused_attention_bwd.launches = 0  # the main path starts
    t_run = time.perf_counter()
    state, printed = run_quiet(train_ddpm.run, cfg, device="cuda")
    wall = time.perf_counter() - t_run
    launches = (fused_attention.launches, fused_attention_bwd.launches)  # the main path ends here
    mma_launches = fused_attention.mma_launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    for line in printed.splitlines():
        log(f"train run 1: {line}")
    steps = 2 * steps_per_epoch
    check(state.step == steps, f"trained {state.step} steps, {steps} expected")
    epochs = re.findall(r"epoch (\d+): (\d+) steps in ([\d.]+) s, ([\d.]+) s/step, ([\d.]+) images/s, "
                        r"train_mse ([\d.naif]+)", printed)
    check(len(epochs) == 2, "two epoch lines")
    encode = re.search(r"latent cache: (\d+) images encoded in ([\d.]+) s", printed)
    check(encode is not None and int(encode.group(1)) == TRAIN_CLASSES * TRAIN_PER_CLASS, "latent cache line")
    records = [json.loads(line) for line in open("results/smoke_train/metrics.jsonl")]
    losses = [r["train_mse"] for r in records if "train_mse" in r]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses), f"{steps} finite train losses")
    check(sum("val_mse" in r and math.isfinite(r["val_mse"]) for r in records) == 2, "two finite val losses")
    init_params = DiffusionTask(cfg, "cpu", vq_params=vq_params).init_state(cfg.run.seed).params
    moved = sum(not torch.equal(state.params[k].cpu(), v) for k, v in init_params.items())
    check(moved >= 0.9 * len(init_params), f"params changed ({moved} of {len(init_params)} tensors)")
    want = 3 * steps
    check(launches[0] >= want and launches[1] >= want,
          f"attention launches fwd {launches[0]}, bwd {launches[1]} >= 3 sites × {steps} steps = {want}")
    check(mma_launches == launches[0], f"every forward attention launch of the run on the tensor-core route "
                                       f"({mma_launches} of {launches[0]})")
    s_per_step = float(np.mean([float(e[3]) for e in epochs[1:]]))
    log(f"train: {steps} steps of batch {cfg.data.batch_size} in {wall:.2f} s wall (with encode, validation, previews, "
        f"checkpoints); epoch 1 {epochs[1][3]} s/step, {epochs[1][4]} images/s (epoch 0 {epochs[0][3]} s/step); "
        f"latent cache encode {encode.group(2)} s for {encode.group(1)} images; losses {losses[0]:.4f} → "
        f"{losses[-1]:.4f}; peak device memory {peak:.2f} GiB; attention launches fwd {launches[0]} "
        f"({mma_launches} on the tensor-core route), bwd {launches[1]} (≥ {want})")

    # resume: a longer schedule from the saved step
    fused_attention.launches = fused_attention_bwd.launches = 0
    state2, printed = run_quiet(train_ddpm.run, dataclasses.replace(cfg, epochs=3), device="cuda")
    for line in printed.splitlines():
        log(f"train run 2: {line}")
    check(f"resumed from step {steps}" in printed, f"the second run resumed from step {steps}")
    check(state2.step == steps + steps_per_epoch, f"resumed run ended at step {state2.step}")
    check(fused_attention_bwd.launches >= 3 * steps_per_epoch, "resumed run launched the backward kernel")

    # the run's checkpoint, served: one dpmpp-20 batch through the kernel
    task = load_task(cfg, torch.device("cuda"))
    fused_attention.launches = fused_attention.mma_launches = 0
    imgs = task.sample(torch.arange(cfg.num_classes), generator=torch.Generator(device="cuda").manual_seed(0),
                       sampler="dpmpp", num_steps=NUM_STEPS)
    check(imgs.shape == (cfg.num_classes, 256, 256, 1) and imgs.dtype == torch.uint8, "served samples' shape")
    check(fused_attention.mma_launches >= 3 * NUM_STEPS, "served sampling went through the tensor-core kernel")
    log(f"train: the checkpoint of step {state2.step} serves through cli.common.load_task: {cfg.num_classes} "
        f"dpmpp-{NUM_STEPS} samples, {fused_attention.launches} forward kernel launches")
    del task, state, state2
    torch.cuda.empty_cache()
    train_step_checks(torch, cfg, s_per_step)
    return launches, cfg


def train_step_checks(torch, cfg, s_per_step: float) -> None:
    """One full-width step through the kernels against the plain attention route
    (same params, t, noise and keep); a step's split; the attention share."""
    from spectrogramgenai_tpu_torch.cli.common import restore
    from spectrogramgenai_tpu_torch.core.ema import ema_update
    from spectrogramgenai_tpu_torch.data.latent_cache import LatentCacheSource
    from spectrogramgenai_tpu_torch.data.pipeline import ImageFolderSource, device_prefetch, iterate_batches
    from spectrogramgenai_tpu_torch.diffusion.ddpm import diffusion_loss
    from spectrogramgenai_tpu_torch.models.layers import SpatialSelfAttention
    from spectrogramgenai_tpu_torch.train.common import microbatch_accumulate
    from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask

    vq = restore(cfg.vqae_ckpt, "VQ-VAE")["params"]
    dev = torch.device("cuda")
    task = DiffusionTask(cfg, dev, vq_params=vq, total_steps=100)
    state = task.init_state(0)
    src = LatentCacheSource(ImageFolderSource("datasets/train", seed=0, img_size=cfg.img_size), task.make_encoder(),
                            dev)
    batch = next(device_prefetch(iterate_batches(src, cfg.data.batch_size), dev))
    x, y = batch["latent"], batch["label"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    t = torch.randint(1, cfg.noise_steps, (len(y),), device="cuda", generator=gen)
    noise = torch.randn(x.shape, device="cuda", generator=gen)
    keep = torch.tensor(1.0, device="cuda")

    def grads_of(fused: bool):
        for m in task.model.modules():
            if isinstance(m, SpatialSelfAttention):
                m.fused = fused
        module = dict(task.model.named_parameters())
        loss, grads, _ = microbatch_accumulate(
            lambda mb: (diffusion_loss(task.model, task.schedule, x, y, t=t, noise=noise, keep=keep), {}), [{}],
            [module[k] for k in state.params])
        return loss.item(), grads

    loss_k, g_k = grads_of(True)
    loss_p, g_p = grads_of(False)
    scale = max(g.norm().item() for g in g_p)
    rel = [((a - b).norm() / b.norm()).item() for a, b in zip(g_k, g_p) if b.norm().item() > 1e-3 * scale]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"train: one full-width bf16 step, kernels vs plain attention route: loss {loss_k:.6f} vs {loss_p:.6f} "
        f"(rel {loss_rel:.3g}, tolerance {STEP_LOSS_TOL}); per-tensor gradient rel. norm max {max(rel):.3g}, median "
        f"{statistics.median(rel):.3g} over {len(rel)} of {len(g_p)} tensors (tolerance {STEP_GRAD_TOL})")
    check(loss_rel <= STEP_LOSS_TOL, f"step loss kernel vs plain {loss_rel:.3g} <= {STEP_LOSS_TOL}")
    check(max(rel) <= STEP_GRAD_TOL, f"step gradients kernel vs plain {max(rel):.3g} <= {STEP_GRAD_TOL}")
    del g_k, g_p

    # a step's split, CUDA events around each part (the train step's own calls)
    for m in task.model.modules():
        if isinstance(m, SpatialSelfAttention):
            m.fused = True
    module = dict(task.model.named_parameters())
    working = [module[k] for k in state.params]
    masters = list(state.params.values())
    batches = device_prefetch(iterate_batches(src, cfg.data.batch_size, epochs=None), dev)
    split = {"data": [], "forward": [], "backward": [], "optimizer": [], "ema": []}
    for i in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        b = next(batches)
        ev[1].record()
        for p in working:
            p.grad = None
        loss = diffusion_loss(task.model, task.schedule, b["latent"], b["label"], generator=state.generator)
        ev[2].record()
        loss.backward()
        ev[3].record()
        for mst, p in zip(masters, working):
            mst.grad = p.grad.float()
        state.opt.param_groups[0]["lr"] = task.lr(state.step)
        state.opt.step()
        ev[4].record()
        ema_update(state.ema_params, state.params, state.step, cfg.ema_beta, cfg.ema_start)
        with torch.no_grad():
            torch._foreach_copy_(working, masters)
        ev[5].record()
        ev[5].synchronize()
        state.step += 1
        if i >= 2:  # after warm-up
            for j, key in enumerate(split):
                split[key].append(ev[j].elapsed_time(ev[j + 1]))
    med = {k: statistics.median(v) for k, v in split.items()}
    log(f"train: one step's split (batch {cfg.data.batch_size}, CUDA events, median of 4): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items()) + f"; sum {sum(med.values()):.3f} ms "
        f"against {1e3 * s_per_step:.1f} ms per step in the run")

    # the attention kernels' share of one step's device time
    b = next(batches)
    check_fwd_route_in_profile("train: one step", log_profile(
        torch, "train: one step", lambda: task.train_step(state, b["latent"], b["label"], encoded=True)))
    del batches


def log_profile(torch, what: str, fn) -> set[str]:
    """Runs fn() once under torch.profiler and prints its device time, the
    attention kernels' shares and the top kernels; returns the names of the
    kernels that ran (empty if the profiler recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def device_us(e) -> float:  # the attribute's name changed across torch versions
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    # device events, less the user annotations (Optimizer.step#…) that span kernels listed on their own
    kernels = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False)]
    total = sum(device_us(e) for e in kernels)
    fwd = sum(device_us(e) for e in kernels if "attention_fwd" in e.key)
    bwd = sum(device_us(e) for e in kernels if "attention_bwd" in e.key)
    if total > 0:
        top = sorted(kernels, key=lambda e: -device_us(e))[:8]
        log(f"{what}: device time {total / 1e3:.3f} ms (torch.profiler): attention fwd "
            f"{100 * fwd / total:.1f} % ({fwd / 1e3:.3f} ms), bwd {100 * bwd / total:.1f} %; top kernels: "
            + "; ".join(f"{e.key[:70]} {device_us(e) / 1e3:.3f} ms" for e in top))
        return {e.key for e in kernels}
    log(f"{what}: torch.profiler recorded no device time; not measured")
    return set()


def check_fwd_route_in_profile(what: str, names: set[str]) -> None:
    """The profile's kernel names show the forward's route: attention_fwd_mma
    ran and attention_fwd_kernel (the scalar one) did not."""
    if not names:
        log(f"{what}: no profile, the route by kernel name is not checked")
        return
    mma = any("attention_fwd_mma" in k for k in names)
    scalar = any("attention_fwd_kernel" in k for k in names)
    check(mma and not scalar, f"{what}: the profile holds attention_fwd_mma ({mma}) and not "
                              f"attention_fwd_kernel ({scalar})")


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
    bwd = phase_attention_bwd(torch, attn)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        make_train_datasets(work)
        vqae_ckpt = phase_train_vqvae(torch)
        train_launches, ddpm_cfg = phase_train(torch, vqae_ckpt)
        phase_classifiers(torch, ddpm_cfg)
        os.chdir(REPO)

    kernels = [{"name": "attention_fwd", "route": "cuda",
                "source": "spectrogramgenai_tpu_torch/csrc/attention_fwd.cu",
                "replaces": "spectrogramgenai_tpu/ops/attention.py:83", "launches": launches + train_launches[0],
                **kern},
               {"name": "attention_bwd", "route": "cuda",
                "source": "spectrogramgenai_tpu_torch/csrc/attention_bwd.cu",
                "replaces": "spectrogramgenai_tpu/ops/attention.py:150", "launches": train_launches[1], **bwd}]
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
