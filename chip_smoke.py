#!/usr/bin/env python3
"""Drive the PyTorch port's serving path, mel front end and training loops once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught and passed over):

  1. device   — CUDA must be available; prints the card's name and power limit
                (nvidia-smi).
  2. build    — compiles csrc/attention_fwd.cu, csrc/attention_bwd.cu and
                csrc/mel_power.cu with nvcc and the host codecs
                csrc/wav_batch.cpp and csrc/png_batch.cpp with g++ from this
                checkout, one compiler per source, started together; prints
                each kernel's registers and spills.
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
                concurrent POST /generate requests for 32 images (each
                request's PNGs from the native encoder, /stats'
                encode_seconds printed), /healthz and /stats; every batch must have gone through the tensor-core
                attention kernel. One request of 27 asks for "audio": true:
                27 WAVs at 22,050 Hz of 97,920 samples, peak-normalised, and
                /stats' audio_seconds for that batch of 27. One served batch's
                device time by kernel (torch.profiler).
 5a. serve_ranks — the serve phase's checkpoints served by python -m
                torch.distributed.run --standalone --nproc_per_node 1 -m
                ...cli.serve (one NCCL rank, rank 0 the front), its requests
                posted one after another: the PNGs pixel-equal to an
                in-process cli.serve.run's answers to the same sequence with
                the same seed, /healthz on cuda:0, the rank line's backend
                nccl and every K1 launch on the tensor-core route; SIGINT to
                rank 0 and exit 0. The torchrun process's start-up, each
                server's seconds a batch (/stats busy_seconds), the control
                channel's calls a batch, and the NCCL kernels in a batch traced
                over a one-rank NCCL mesh in this process.
 5b. export   — from the serve phase's checkpoints: cli.export_model.run
                writes a dpmpp-20 artifact at 27 labels (torch.export programs
                of the UNet's ε forward and the VQ decode in a zip) and checks
                it (--check); the artifact loaded here against eager
                task.sample with the same seed (max uint8 difference within
                EXPORT_U8_TOL), K1 launched 60 times a batch through the
                operator spectrogramgenai_tpu_torch::attention_fwd, all on the
                tensor-core route, attention_fwd_mma in a batch's profile;
                images/s artifact against eager (alternating batches, host
                clock); python -m ...cli.generate --artifact in a fresh
                process (27 PNGs named by class); cli.serve.run(artifact=…)
                answering POST /generate and /stats; then a ddpm artifact's
                999-step chain (2,997 launches), its wall printed beside the
                trajectory phase's eager chain. Export seconds and MB.
 5c. invert   — audio/invert.db_mel_to_audio at full width (256 mels × 256
                frames, n_fft 2048, hop 384) on 27 tone-plus-noise clips: the
                card's float32 chain against the same function in float64 on
                the CPU (2 rows; the waveform after the 32 NNLS iterations and
                one synthesis, and at the full 32 + 32 the re-analysed log-mel,
                since Griffin-Lim amplifies rounding), the round trip within
                tests/test_invert.py's bounds (mean |ΔdB| < 3, correlation
                > 0.9 after re-analysis with the port's log-mel); the chain's
                time (CUDA events), and cli.spec_to_wav.run on 32 viridis
                PNGs at batch 32: clips/s and its load / NNLS / Griffin-Lim /
                resample / write split.
  6. gen_specs — a synthetic corpus (32 recordings of 60 s at 22,050 Hz and 2
                at 48 kHz, 8 detections each) through cli.gen_specs.run on the
                card, once per rung: every PNG written and 256×256×3, the
                exact .npy arrays at the exact rung's bound against the oracle,
                exact and high PNGs within 2 levels, a kernel launch per batch;
                specs/s and the decode / mel kernel / dB glue / encode split;
                the native WAV decoder's rows bit-equal to load_wav +
                slice_clip, the PNGs read back by the native decoder (0
                rejected) as the L of their pixels.
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
                (torch.profiler) and peak memory; the loader's PNG decode
                (native, 0 rows handed back) and its seconds.
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
  9a. parallel — the mesh layer on the card, at world size 1 over NCCL:
                python -m torch.distributed.run --standalone --nproc_per_node 1
                -m ...cli.train_ddpm with the train phase's flags (its datasets
                and VQ-VAE checkpoint, the DDPMConfig defaults, batch 32, 2
                epochs of 8 steps; one checkpoint, at the end) under
                --run.param_sharding replicate and fsdp (with --profile_dir):
                the backend nccl, the collectives
                called (the gradient bucket every step; reduce-scatter and
                all-gather under fsdp), K1 on the tensor-core route and K1b
                launched inside the rank (each rank's counters on its "rank"
                JSON line), every tensor of the step-16 checkpoint bit-equal
                to the train phase's run without a process group; s/step with
                and without the process group, and the NCCL kernels and
                collective calls in the fsdp run's trace.
 9b. trajectory — cli.generate --sav_denoise_path from that checkpoint: the
                999-step DDPM chain with CFG over the 27 labels (UNet batch
                54), 21 steps × 27 classes × 2 PNGs (latent grid, VQ decode),
                K1 at 3 sites × 999 steps on the tensor-core route, the wall.
  9c. profile_dir — cli.train_ddpm --profile_dir for 2 steps of batch 32: the
                Chrome trace loads as JSON and names the attention_fwd and
                attention_bwd kernels.
 10. classifiers — cli.generate.run writes 3 dpmpp-20 images per class from
                the trained DDPM ({class}_gen_imgs_{i}_{samp}.png);
                cli.train_classifiers runs the custom CNN and ResNet18 at 0 and
                2 synthetic images per class for 2 epochs (batch 16, 256×256,
                val standing in as test): finite losses, a CSV row per epoch,
                the best checkpoint, the synthetic count per class, ResNet18's
                frozen prefix bit-equal to its init with its BatchNorm
                statistics moved; one train step each of VGG16, MobileNetV2 and
                the ensemble; cli.eval_classifiers on the best checkpoints
                with its confusion PNGs (a viridis block per cell, min to
                max); s/epoch, images/s, step times and peak memory; the
                sweep's PNG decode (native, 0 rows handed back).
 10a. parallel_classifier — the sweep's ResNet18 synth-0 run (BatchNorm; 2
                epochs, batch 16, 256×256) again under torchrun with one NCCL
                rank and fsdp: reduce-scatter and all-gather called, the best
                checkpoint (BatchNorm statistics included) bit-equal to the
                sweep's.
 10b. figures — tools/port_make_experiment_figure.py on the corpus's real
                and the generated PNGs (3 species rows), and
                tools/port_analyse_results.py on the sweep's results with its
                acc_vs_synth.png: both PNGs decode at their expected sizes.
 11. fid      — tools/port_fid_batch.py with the sweep's best custom synth-0
                classifier (bf16): FID of val against train, of val against
                the generated images (finite, ≥ 0) and of val against itself
                (near 0); the features' images/s; the classifier's features
                on the card against the CPU's at float32 (TF32 off).
 11b. evaluators — JAX-layout checkpoints (core/flax_msgpack.to_bytes of
                bridge.flax_from_state_dict) of seeded random InceptionV3, CLAP
                (HTSAT-tiny) and ResNet18 (1000 classes) weights; two WAV
                directories at 22,050 Hz (two 6-s clips of each class recording;
                cli.spec_to_wav of the generated PNGs); cli.inception_score on the
                generated PNGs, cli.fid's Inception path (val against generated),
                cli.fad in mel and clap mode and the generated audio against itself,
                cli.verify_metrics.run on both pairs (IS ≥ 1, FID and FAD finite and
                ≥ 0, the self-FAD near 0, verify_metrics' scores the CLIs'); images/s
                (load/resize, forward) and clips/s (load/resample, mel front end,
                tower); InceptionV3's logits and features and the CLAP embeddings
                card against CPU (float32, TF32 off); cli.train_classifiers
                --pretrained_dir for one epoch of ResNet18 (the loaded count, the
                head fresh, the frozen prefix the file's); the exact mel kernel at
                the CLAP shape (8 × 481,024 samples, n_fft 1024, hop 480, 64 mels,
                centre off) and the FAD shape (32 clips at 48 kHz) against its plain
                version and the float64 oracle, timed.
 11c. provision — tools/port_provision_eval_weights.py on the card into
                eval_provisioned/: seeded random tests/torch_refs.py InceptionV3
                and ResNet18 state_dicts (1000 classes, convolutions × 2√2) as
                .pth files, converted, verified on cuda against the torch oracle
                (float32, TF32 off, max-abs logit error ≤ 5e-3) and installed as
                inception_v3.msgpack and resnet18_imagenet.msgpack, each read
                back (load_inception_params, ClassifierTask.pretrained_variables)
                bit-equal to the converted tree; an HF-layout state_dict of a
                random port CLAP tower refused without --skip_verify while
                transformers is hidden, installed with it, the file holding the
                starting tree, then, where transformers is installed, verified
                against its tower on cuda (≤ 5e-3); cli.verify_metrics.run on the evaluators' pairs
                (IS, FID and CLAP-FAD from those files, no random-weights
                warning; K2 exact at the CLAP shape, counted on the main path)
                and one epoch of cli.train_classifiers --pretrained_dir
                eval_provisioned for ResNet18 (its non-head parameters loaded);
                seconds, errors and MB per model.
 12. acgan    — cli.train_acgan.run on the 27-class corpus at the ACGANConfig
                defaults (generator 512 → 32 channels, 256×256, noise 64 + 27,
                batch 16, bf16, RMSprop) for epochs 1 … 10, to its checkpoint
                at epoch 10, then one epoch resumed with st_epochs 10: every
                loss finite, d_acc in [0, 1], a CSV row and a sample grid per
                epoch, bn1's running statistics and every spectral norm's u
                moved, u of unit norm, the resumed state at the saved step and
                the checkpoint restoring the saved state exactly; s/step,
                images/s, one step's device time by kernel (torch.profiler),
                peak memory; the trained generator's and discriminator's bf16
                forward on the card against float32 on the CPU.
 12b. acgan_manifest — cli.train_acgan in manifest mode (--manifest
                specdata.npz of the corpus's train rows, --lab_csv, --ai_csv
                with the 11 acoustic indices, --use_aind true) for one epoch
                at the ACGANConfig defaults: 16 steps, finite losses, the
                native decode with 0 rows handed back.
 13. specunet — synthetic noise and bird recordings (a quarter at 44.1 kHz,
                resampled to 22,050 Hz) with their CSVs; the exact mel kernel
                at the mix shape (3 × 8 clips of 2¹⁷ samples) against its plain
                version and, before the midpoint normalisation, the float64
                oracle within the exact rung's dB bounds, timed against the
                plain version and torch.stft + filterbank; then
                cli.train_specunet.run in separate mode at the SpecUNetConfig
                defaults (batch 8, bf16, d_model 512, 6 layers) for 2 epochs
                and in denoise mode for 1, which writes the denoiser's
                checkpoint: finite losses, the separation figure, a mel kernel
                launch per batch; s/step and the load/resample, mel kernel,
                normalise and step split.
 14. denoised classifiers — cli.train_classifiers with --denoiser_ckpt (the
                denoise run) for the custom net, one epoch: finite losses; the
                denoiser's float32 forward on the card against the CPU (TF32
                off).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when CUDA
is absent or any check fails.
"""

from __future__ import annotations

import base64
import contextlib
import csv
import importlib.util
import io
import json
import math
import os
import re
import signal
import socket
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
REQUESTS = ({"label": "class00", "count": 1}, {"label": 5, "count": 4}, {"label": 26, "count": 27},
            {"label": 7, "count": SERVE_BATCH, "audio": True})
AUDIO_SR, AUDIO_SAMPLES = 22050, (256 - 1) * 384  # a 256-frame spectrogram's span at hop 384
KERNEL_SOURCES = ("attention_fwd", "attention_bwd", "mel_power")
HOST_SOURCES = ("wav_batch", "png_batch")  # the host codecs (g++), built beside the kernels
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
# the inversion on the card (float32) against float64 on the CPU: the waveform
# after the 32 NNLS iterations and one synthesis, no Griffin-Lim (relative L2;
# float32 on the CPU reads 8.9e-6: each Griffin-Lim iteration then amplifies
# rounding, 1.4e-3 after one, 4.2e-2 after four), the re-analysed log-mel after
# the full 32 + 32 (mean |ΔdB|; CPU 0.012); the round trip (tests/test_invert.py)
INVERT_SHORT_REL, INVERT_FULL_DB, ROUNDTRIP_DB, ROUNDTRIP_CORR = 1e-4, 0.1, 3.0, 0.9
# FID of a directory against itself, and the classifier's float32 features,
# card against CPU (relative to the largest logit)
FID_SELF_TOL, FEATURE_TOL = 1e-3, 1e-4
ACGAN_EPOCHS = 10  # cli.train_acgan runs epochs 1 … 10 and saves at 10; then one more, resumed
# the trained ACGAN's bf16 forward on the card against float32 on the CPU, the
# same weights: relative L2 of the generator's output and the discriminator's
# class log-probabilities (bf16 keeps 8 bits: ~4e-3 a rounding, over ~15 layers)
GAN_BF16_TOL = 5e-2
SPECUNET_PAIRS, SPECUNET_BATCH = 48, 8
# the denoiser's float32 forward, card (TF32 off) against CPU, relative to 1
DENOISER_TOL = 1e-4
# the evaluators: InceptionV3's and the CLAP tower's float32 outputs card (TF32 off) against CPU,
# relative L2; the CLAP-FAD of a directory against itself (scipy's sqrtm of a rank-deficient product)
TOWER_TOL, EVAL_SELF_FAD_TOL = 1e-4, 1e-3
# the exported sampler against eager sampling (the same kernels in the same order: bit-equal,
# a reading of 0 on an NVIDIA H100): the chain's latents, max abs; the images, max uint8
EXPORT_LATENT_TOL, EXPORT_U8_TOL = 0.0, 0
EXPORT_TIMED_BATCHES = 5
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
    """The (height, width, 3) pixels of an 8-bit RGB PNG that the port's native
    encoder wrote (every row Sub-filtered), after checking its header, its
    inflated size and its filter bytes."""
    from spectrogramgenai_tpu_torch.audio.export import decode_png_rgb

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
    check(bool((np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)[:, 0] == 1).all()),
          "Sub-filtered PNG rows (the native encoder's)")
    return decode_png_rgb(png)


@contextlib.contextmanager
def counted_decode():
    """Sums the training loaders' PNG decodes (``data/pipeline.decode_gray_batch``)
    while it is open: {"seconds", "rows"}, and on exit "rejected", the rows the
    native decoder handed back to the NumPy reader."""
    from spectrogramgenai_tpu_torch.data import native_png, pipeline

    stats = {"seconds": 0.0, "rows": 0}
    inner = pipeline.decode_gray_batch

    def timed(paths, *args, **kw):
        t = time.perf_counter()
        out = inner(paths, *args, **kw)
        stats["seconds"] += time.perf_counter() - t
        stats["rows"] += len(paths)
        return out

    native_png.load_png_batch_gray.rejected = 0
    pipeline.decode_gray_batch = timed
    try:
        yield stats
    finally:
        pipeline.decode_gray_batch = inner
        stats["rejected"] = native_png.load_png_batch_gray.rejected


def log_decode(what: str, stats: dict) -> None:
    check(stats["rows"] > 0 and stats["rejected"] == 0,
          f"{what}: {stats['rows']} PNG rows decoded, {stats['rejected']} handed back by the native decoder (0)")
    log(f"{what}: PNG decode {stats['rows']} rows in {stats['seconds']:.3f} s through the native decoder "
        f"({stats['rows'] / max(stats['seconds'], 1e-9):.0f} rows/s, host clock, in the loader's thread), "
        f"0 handed back")


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
    for exact, rung, _ in MEL_RUNGS:
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
        out[rung] = {"max_abs_err": max_abs, "max_rel_err": max_rel,
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
    from spectrogramgenai_tpu_torch.audio.export import save_spectrogram_npy, spectrogram_rgb
    from spectrogramgenai_tpu_torch.cli import gen_specs
    from spectrogramgenai_tpu_torch.data.native_png import load_png_batch_gray, save_png_batch_rgb
    from spectrogramgenai_tpu_torch.data.native_wav import load_wav_batch
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
        if rung == "exact":
            exact_rgb = np.stack(rgb)
        log(f"gen_specs {rung}: {n_done} specs in {wall:.3f} s wall → {n_done / wall:.1f} specs/s end to end; "
            f"decode {split.group(1)} s, mel kernel {split.group(2)} s, dB glue {split.group(3)} s, "
            f"encode {split.group(5)} s; "
            f"{launches[rung]} launches")

    # the native WAV decoder's rows (gen_specs' decode) against load_wav + slice_clip, bit for bit,
    # and the exact rung's arrays against the float64 oracle of those clips
    t_dec = time.perf_counter()
    decoded, rates = load_wav_batch([os.path.join(wav_dir, r["file_name"]) for r in rows],
                                    [r["begin_time"] for r in rows], [r["end_time"] for r in rows], 6.0)
    t_dec = time.perf_counter() - t_dec
    worst, loaded = 0.0, {}
    for row, name, got_clip, got_sr in zip(rows, names, decoded, rates.tolist()):
        if row["file_name"] not in loaded:
            loaded = {row["file_name"]: load_wav(os.path.join(wav_dir, row["file_name"]))}
        wav, sr = loaded[row["file_name"]]
        clip = slice_clip(wav, sr, row["begin_time"], row["end_time"])
        check(got_sr == sr and np.array_equal(got_clip[:len(clip)].view(np.int32), clip.view(np.int32))
              and not got_clip[len(clip):].any(), f"{name}: the native WAV row is load_wav + slice_clip's, bit for bit")
        want = reference_logmel_np(clip, SpectrogramConfig(sample_rate=sr))
        got = np.load(os.path.join(work, "images_exact", name.replace(".png", ".npy")))
        worst = max(worst, float(np.abs(got - want).max()))
    log(f"gen_specs: native WAV decoder: {len(rows)} rows ({decoded.shape[1]} samples wide) in {t_dec:.3f} s, "
        f"bit-equal to load_wav + slice_clip")
    # the written PNGs back through the native decoder: every row read, L of the written pixels
    load_png_batch_gray.rejected = 0
    t_png = time.perf_counter()
    gray, ok = load_png_batch_gray([os.path.join(work, "images_exact", n) for n in names], 256, 256)
    t_png = time.perf_counter() - t_png
    l_want = ((exact_rgb[..., 0].astype(np.uint32) * 19595 + exact_rgb[..., 1].astype(np.uint32) * 38470
               + exact_rgb[..., 2].astype(np.uint32) * 7471 + 0x8000) >> 16).astype(np.uint8)
    check(bool(ok.all()) and load_png_batch_gray.rejected == 0, "the native PNG decoder read every PNG (0 rejected)")
    check(np.array_equal(gray, l_want), "native grayscale decode = PIL's L of the PNGs' pixels")
    log(f"gen_specs: native PNG decoder: {len(names)} PNGs in {t_png:.3f} s, 0 rejected, L of the pixels exactly")
    # the encode stage of one batch of 64, split: colormap, native PNG encode + write, .npy writes (host clock)
    specs = np.stack([np.load(os.path.join(work, "images_exact", n.replace(".png", ".npy"))) for n in names[:64]])
    split_dir = os.path.join(work, "encode_split")
    os.makedirs(split_dir)
    paths = [os.path.join(split_dir, f"{i}.png") for i in range(64)]
    stages = {"colormap": lambda: spectrogram_rgb(specs),
              "PNG encode + write": lambda: save_png_batch_rgb(rgb64, paths),
              ".npy writes": lambda: [save_spectrogram_npy(x, p.replace(".png", ".npy")) for x, p in zip(specs, paths)]}
    rgb64, times = spectrogram_rgb(specs), {}
    for stage, fn in stages.items():
        runs = []
        for _ in range(3):
            t = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t)
        times[stage] = statistics.median(runs)
    log("gen_specs: the encode stage of a batch of 64 (host clock, median of 3): "
        + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in times.items()))
    check(worst <= RUNG_BOUNDS[True][0],
          f"gen_specs exact .npy vs oracle {worst:.3g} dB <= {RUNG_BOUNDS[True][0]}")
    high_levels = int(np.abs(indices["exact"] - indices["high"]).max())
    fast_levels = int(np.abs(indices["exact"] - indices["fast"]).max())
    check(high_levels <= 2, f"exact and high PNGs within 2 levels ({high_levels})")
    log(f"gen_specs: exact .npy vs float64 oracle max {worst:.3g} dB; PNG levels exact vs high ≤ {high_levels}, "
        f"exact vs fast ≤ {fast_levels}")
    return launches


def phase_serve(torch, work: str) -> int:
    from scipy.io import wavfile

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
                                block=False, device="cuda", warm_audio=True)
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
        check(("audio" in body) == bool(p.get("audio")), f"request {p}: audio only when asked for")
        if p.get("audio"):
            check(len(body["audio"]) == p["count"] and body["sample_rate"] == AUDIO_SR,
                  f"request {p} → {len(body['audio'])} WAVs at {body['sample_rate']} Hz")
            for wav in body["audio"]:
                sr, data = wavfile.read(io.BytesIO(base64.b64decode(wav)))
                peak = int(np.abs(data.astype(np.int32)).max())
                # peak-normalised: the loudest sample is ±32767; a NaN would not be
                check(sr == AUDIO_SR and data.dtype == np.int16 and data.shape == (AUDIO_SAMPLES,)
                      and 32000 <= peak <= 32767, f"WAV: {sr} Hz, {data.dtype} {data.shape}, peak {peak}")
    check(health[0] == 200 and health[1]["ok"] and health[1]["backend"] == "cuda", f"healthz {health}")
    check(stats["audio_seconds"] > 0, f"/stats audio_seconds {stats['audio_seconds']} > 0")
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
    log(f"serve: audio for a served batch of {SERVE_BATCH}: {stats['audio_seconds']:.3f} s (/stats audio_seconds: "
        f"inversion on the card, 32 NNLS + 32 Griffin-Lim iterations, and the WAV encode) → "
        f"{SERVE_BATCH / stats['audio_seconds']:.1f} clips/s")
    log(f"serve: attention kernel launches {launches} (≥ {want}), {mma_launches} on the tensor-core route")
    enc = stats["encode_seconds"] - warm["encode_seconds"]
    check(enc > 0, "/stats encode_seconds moved")
    log(f"serve: PNG encode (native encoder, one call a request) {enc:.3f} s for {n_images} images in "
        f"{len(REQUESTS)} requests (/stats encode_seconds) → {1e3 * enc / n_images:.3f} ms an image")

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


def child_pids(pid: int) -> list[int]:
    """The processes whose parent is ``pid`` (from /proc)."""
    kids = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if int(stat[stat.rindex(")") + 2:].split()[1]) == pid:
                kids.append(int(entry))
    return kids


def post_in_turn(base: str) -> tuple[list[dict], dict, float]:
    """REQUESTS posted one after another (each batch's labels fixed by the
    order alone): the bodies, /stats before them, and the wall of the full
    batch without audio (label 26)."""
    with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
        warm = json.loads(r.read())
    bodies, full_s = [], 0.0
    for p in REQUESTS:
        req = urllib.request.Request(f"{base}/generate", data=json.dumps(p).encode(), method="POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            check(r.status == 200, f"request {p} → {r.status}")
            bodies.append(json.loads(r.read()))
        if p["label"] == 26:
            full_s = time.perf_counter() - t
        check(len(bodies[-1]["images"]) == p["count"], f"request {p}: {p['count']} images")
    return bodies, warm, full_s


def phase_serve_ranks(torch, work: str) -> int:
    """cli.serve under torchrun at one NCCL rank, from the serve phase's
    checkpoints, against cli.serve.run in this process; returns the rank's K1 launches."""
    import torch.distributed as dist

    from spectrogramgenai_tpu_torch.cli import serve
    from spectrogramgenai_tpu_torch.cli.common import load_task, make_mesh
    from spectrogramgenai_tpu_torch.core.config import DDPMConfig, RunConfig

    os.chdir(work)
    cfg = DDPMConfig(run=RunConfig(run_name="smoke_ddpm", seed=0), vqae_ckpt="models/smoke_vq")
    names = [f"class{i:02d}" for i in range(cfg.num_classes)]
    batches = 1 + len(REQUESTS)  # the warm-up, then one a request (none holds more than a batch)

    # the in-process server's answers, the requests posted one after another
    server, batcher = serve.run(cfg, port=0, serve_batch=SERVE_BATCH, sampler="dpmpp", num_steps=NUM_STEPS,
                                class_names=names, block=False, device="cuda")
    try:
        want, warm, want_full_s = post_in_turn(f"http://127.0.0.1:{server.port}")
        stats = batcher.snapshot_stats()
    finally:
        server.shutdown()
        batcher.close()
    check(stats["batches"] == batches, f"in-process: {batches} batches ({stats['batches']})")
    want_batch_s = (stats["busy_seconds"] - warm["busy_seconds"]) / (batches - 1)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, (REPO, os.environ.get("PYTHONPATH"))))}
    args = ["--run.run_name", cfg.run.run_name, "--vqae_ckpt", cfg.vqae_ckpt, "--run.seed", str(cfg.run.seed),
            "--port", str(port), "--serve_batch", str(SERVE_BATCH), "--sampler", "dpmpp",
            "--num_steps", str(NUM_STEPS)]
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    with open("serve_ranks.out", "w") as out, open("serve_ranks.err", "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                                 "1", "-m", "spectrogramgenai_tpu_torch.cli.serve", *args], stdout=out, stderr=err,
                                env=env)
    try:
        health = None
        while health is None and time.perf_counter() - t0 < 300:
            check(proc.poll() is None, f"torchrun serve exited {proc.returncode}:\n"
                                       f"{open('serve_ranks.err').read()[-4000:]}")
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
                    health = (r.status, json.loads(r.read()))
            except OSError:
                time.sleep(0.2)
        startup_s = time.perf_counter() - t0
        check(health is not None, "torchrun serve: /healthz answered within 300 s")
        got, got_warm, got_full_s = post_in_turn(base)
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
            got_stats = json.loads(r.read())
        t_stop = time.perf_counter()
        for pid in child_pids(proc.pid):  # rank 0: torchrun's one worker
            os.kill(pid, signal.SIGINT)
        rc = proc.wait(timeout=120)
        stop_s = time.perf_counter() - t_stop
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    printed = open("serve_ranks.out").read()
    check(rc == 0, f"torchrun serve exited {rc} after SIGINT to rank 0:\n{printed[-2000:]}\n"
                   f"{open('serve_ranks.err').read()[-4000:]}")
    check(health[0] == 200 and health[1]["ok"] and health[1]["device"] == "cuda:0", f"healthz {health}")
    check(got_stats["batches"] == batches, f"torchrun serve: {batches} batches ({got_stats['batches']})")
    for p, g, w in zip(REQUESTS, got, want):
        same = all(np.array_equal(png_rgb(base64.b64decode(a)), png_rgb(base64.b64decode(b)))
                   for a, b in zip(g["images"], w["images"]))
        check(same, f"request {p}: the torchrun server's images pixel-equal to the in-process server's")
        check(("audio" in g) == bool(p.get("audio")), f"request {p}: audio only when asked for")
    rank = rank_report(printed, "torchrun serve")
    kern, calls = rank["kernels"], rank["collectives"]
    check(rank["backend"] == "nccl" and rank["mesh"] == {"data": 1, "model": 1} and rank["device"] == "cuda:0",
          f"serve_ranks: one NCCL rank on cuda:0 ({rank})")
    want_k1 = len(SA_SITES) * NUM_STEPS * batches
    check(kern["attention_fwd"] >= want_k1 and kern["attention_fwd_mma"] == kern["attention_fwd"],
          f"serve_ranks: K1 ≥ {want_k1} launches, all on the tensor-core route ({kern})")
    got_batch_s = (got_stats["busy_seconds"] - got_warm["busy_seconds"]) / (batches - 1)
    log(f"serve_ranks: torchrun --nproc_per_node 1 cli.serve up (/healthz 200) {startup_s:.2f} s after its start "
        f"(the agent, imports, NCCL, checkpoints, one warm-up chain); {len(REQUESTS)} requests in turn, images "
        f"pixel-equal to the in-process server's; SIGINT to rank 0 → exit 0 in {stop_s:.2f} s")
    log(f"serve_ranks: seconds a batch (/stats busy_seconds, host clock, dpmpp-{NUM_STEPS}, batch {SERVE_BATCH}): "
        f"torchrun rank {got_batch_s:.4f}, in-process {want_batch_s:.4f}; the full batch's request wall "
        f"{got_full_s:.4f} against {want_full_s:.4f} s")
    log(f"serve_ranks: rank line {json.dumps(rank)}; control channel calls a batch "
        f"{sum(v for k, v in calls.items() if k.startswith('control')) / batches:.2f} (one rank: no followers)")

    # one batch traced over a one-rank NCCL mesh in this process: its NCCL kernels
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        store_port = s.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store_port), WORLD_SIZE="1", RANK="0",
                      LOCAL_RANK="0")
    try:
        mesh = make_mesh(cfg.run, torch.device("cuda", 0))
        task = load_task(cfg, torch.device("cuda", 0), mesh=mesh)
        gen = torch.Generator(device="cuda").manual_seed(4)
        labels = torch.arange(SERVE_BATCH) % cfg.num_classes
        task.sample(labels, generator=gen, sampler="dpmpp", num_steps=NUM_STEPS)  # warm
        trace = os.path.join(work, "serve_ranks_trace.json")
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            task.sample(labels, generator=gen, sampler="dpmpp", num_steps=NUM_STEPS)
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        traced = trace_collectives(trace)
        log(f"serve_ranks: one batch over a one-rank NCCL mesh ({mesh.backend()}), traced: "
            f"{traced['nccl_kernels']} NCCL kernels, {traced['nccl_ms']:.3f} ms of {traced['kernel_ms']:.1f} ms "
            f"device kernel time; collective calls {traced['calls']}; mesh calls {dict(mesh.calls)}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
            os.environ.pop(var, None)
    return kern["attention_fwd"]


def phase_export(torch, work: str) -> tuple[int, float]:
    """cli.export_model from the serve phase's checkpoints (in ``work``):
    dpmpp-20 at 27 labels, held to eager sampling, K1's launches and kernel
    names, images/s against eager, cli.generate --artifact in a fresh
    process, cli.serve --artifact over HTTP; then the 999-step ddpm chain.
    Returns K1's launches on the main path and the ddpm chain's wall."""
    from spectrogramgenai_tpu_torch.cli import export_model, serve
    from spectrogramgenai_tpu_torch.cli.common import load_task
    from spectrogramgenai_tpu_torch.core.config import DDPMConfig, RunConfig
    from spectrogramgenai_tpu_torch.ops.attention import fused_attention
    from spectrogramgenai_tpu_torch.serving.export import load_artifact

    os.chdir(work)
    cfg = DDPMConfig(run=RunConfig(run_name="smoke_ddpm", seed=0), vqae_ckpt="models/smoke_vq")
    labels = np.arange(SERVE_BATCH) % cfg.num_classes
    sites = len(SA_SITES)

    def exported(sampler: str, num_steps: int, check_it: bool) -> str:
        out = f"models/smoke_sampler_{sampler}.zip"
        t0 = time.perf_counter()
        _, printed = run_quiet(export_model.run, cfg, out=out, num_labels=SERVE_BATCH, sampler=sampler,
                               num_steps=num_steps, check=check_it, device="cuda")
        wall = time.perf_counter() - t0
        for line in printed.splitlines():
            log(f"export: {line}")
        took = re.search(r"\(([\d.]+) MB\) in ([\d.]+) s", printed)
        check(took is not None, "cli.export_model prints the artifact's size and the export's seconds")
        log(f"export: {sampler}-{num_steps} at {SERVE_BATCH} labels: export {took.group(2)} s, artifact "
            f"{os.path.getsize(out) / 1e6:.1f} MB; cli.export_model.run {wall:.2f} s wall (load, export"
            + (", reload and one batch)" if check_it else ")"))
        if check_it:
            check(f"check: artifact generated ({SERVE_BATCH}, {cfg.img_size}, {cfg.img_size}, 1) uint8" in printed,
                  "--check generated one batch")
        return out

    path = exported("dpmpp", NUM_STEPS, True)
    t0 = time.perf_counter()
    art = load_artifact(path)
    log(f"export: load_artifact {time.perf_counter() - t0:.2f} s (device {art.device})")
    task = load_task(cfg, torch.device("cuda"))

    def eager(seed: int) -> np.ndarray:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return task.sample(labels, generator=gen, sampler="dpmpp", num_steps=NUM_STEPS).cpu().numpy()

    fused_attention.launches = fused_attention.mma_launches = 0  # the main path starts here
    lat = art.sample_latents(3, labels)
    got = art.decode(lat).cpu().numpy()
    check((fused_attention.launches, fused_attention.mma_launches) == (sites * NUM_STEPS, sites * NUM_STEPS),
          f"one artifact batch launched K1 {fused_attention.launches} times, {fused_attention.mma_launches} on "
          f"the tensor-core route ({sites} sites × {NUM_STEPS} steps = {sites * NUM_STEPS})")
    want_lat = task.sample_latents(labels, generator=torch.Generator(device="cuda").manual_seed(3),
                                   sampler="dpmpp", num_steps=NUM_STEPS)
    want = task.decode(want_lat).cpu().numpy()
    lat_err = (lat - want_lat).abs().max().item()
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    # the random VQ-VAE decodes every latent to ~127 (its output is within ±0.002),
    # so the latents carry the comparison and the images only their shape
    log(f"export: artifact vs eager, seed 3, dpmpp-{NUM_STEPS} at {SERVE_BATCH} labels: latents max abs difference "
        f"{lat_err:.3g} (tolerance {EXPORT_LATENT_TOL}; latents std {lat.std().item():.4g}, max |x| "
        f"{lat.abs().max().item():.4g}), uint8 images max difference {int(diff.max())} (tolerance "
        f"{EXPORT_U8_TOL}), {len(np.unique(got))} distinct levels")
    check(bool(torch.isfinite(lat).all()) and lat.std().item() > 0, "the artifact's latents finite and not constant")
    check(got.shape == (SERVE_BATCH, cfg.img_size, cfg.img_size, 1) and got.dtype == np.uint8,
          f"artifact images {got.shape} {got.dtype}")
    check(lat_err <= EXPORT_LATENT_TOL and int(diff.max()) <= EXPORT_U8_TOL,
          f"artifact vs eager: latents {lat_err} <= {EXPORT_LATENT_TOL}, uint8 {int(diff.max())} <= {EXPORT_U8_TOL}")
    what = f"export: one artifact batch (dpmpp-{NUM_STEPS}, {SERVE_BATCH} labels)"
    check_fwd_route_in_profile(what, log_profile(torch, what, lambda: art(4, labels)))

    # images/s, artifact against eager, alternating (host clock; each call ends in a copy to the host)
    times = {"artifact": [], "eager": []}
    for i in range(EXPORT_TIMED_BATCHES):
        for name, fn in (("artifact", art), ("eager", lambda s, _: eager(s))):
            t = time.perf_counter()
            fn(10 + i, labels)
            times[name].append(time.perf_counter() - t)
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"export: dpmpp-{NUM_STEPS} at batch {SERVE_BATCH}, median of {EXPORT_TIMED_BATCHES} alternating batches: "
        f"artifact {med['artifact']:.4f} s ({SERVE_BATCH / med['artifact']:.2f} images/s), eager "
        f"{med['eager']:.4f} s ({SERVE_BATCH / med['eager']:.2f} images/s); artifact / eager "
        f"{med['artifact'] / med['eager']:.3f}")
    del task

    # cli.generate --artifact in a fresh process on the card
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "spectrogramgenai_tpu_torch.cli.generate", "--artifact", path,
                           "--img_folder", "gen_artifact", "--num_samples", "1"], cwd=work, capture_output=True,
                          text=True, timeout=600, env={**os.environ, "PYTHONPATH": REPO})
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli.generate --artifact exited {proc.returncode}: {proc.stderr[-2000:]}")
    names = sorted(os.listdir("gen_artifact"))
    want_names = sorted(f"class{i:02d}_gen_imgs_{i}_0.png" for i in range(cfg.num_classes))
    check(names == want_names, f"cli.generate --artifact wrote {len(names)} PNGs named by class ({len(want_names)})")
    with open(f"gen_artifact/{names[0]}", "rb") as f:
        check(png_rgb(f.read()).shape == (cfg.img_size, cfg.img_size, 3), "a generated PNG of the image size")
    log(f"export: python -m spectrogramgenai_tpu_torch.cli.generate --artifact in a fresh process: "
        f"{len(names)} PNGs in {wall:.2f} s wall (process start, load, one batch, PNG writes)")

    # cli.serve --artifact: no checkpoint, no model code
    before = fused_attention.launches
    server, batcher = serve.run(DDPMConfig(), port=0, class_names=[f"class{i:02d}" for i in range(cfg.num_classes)],
                                block=False, device="cuda", artifact=path)
    results: dict[int, tuple[int, dict]] = {}
    requests = REQUESTS[:3]
    try:
        base = f"http://127.0.0.1:{server.port}"

        def post(i, payload):
            req = urllib.request.Request(f"{base}/generate", data=json.dumps(payload).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                results[i] = (r.status, json.loads(r.read()))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i, p)) for i, p in enumerate(requests)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        batcher.close()
    for i, p in enumerate(requests):
        status, body = results[i]
        check(status == 200 and len(body["images"]) == p["count"], f"artifact-served request {p} → {status}, "
                                                                    f"{len(body['images'])} images")
        check(png_rgb(base64.b64decode(body["images"][0])).shape == (cfg.img_size, cfg.img_size, 3),
              "a served PNG of the image size")
    n_images = sum(p["count"] for p in requests)
    served_launches = fused_attention.launches - before
    check(served_launches == sites * NUM_STEPS * stats["batches"],
          f"artifact serving: K1 launches {served_launches} = {sites} × {NUM_STEPS} × {stats['batches']} batches")
    log(f"export: cli.serve.run(artifact=…): {n_images} images in {len(requests)} requests, {stats['batches']} "
        f"batches with the warmup, {wall:.3f} s wall; stats {json.dumps(stats)}")

    # the 999-step ddpm chain from an artifact
    path = exported("ddpm", 50, False)
    art = load_artifact(path)
    before = fused_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = art.sample_latents(0, labels)
    imgs = art.decode(lat).cpu().numpy()
    chain_s = time.perf_counter() - t0
    steps = cfg.noise_steps - 1
    chain_launches = fused_attention.launches - before
    launches, mma_launches = fused_attention.launches, fused_attention.mma_launches  # the main path ends here
    check(chain_launches == sites * steps, f"the ddpm artifact's chain launched K1 {chain_launches} times "
                                           f"({sites} sites × {steps} steps)")
    check(imgs.shape == (SERVE_BATCH, cfg.img_size, cfg.img_size, 1) and bool(torch.isfinite(lat).all()),
          "the ddpm artifact's images, and its latents finite")
    check(mma_launches == launches, f"every K1 launch of the phase on the tensor-core route ({mma_launches} of "
                                    f"{launches})")
    log(f"export: the ddpm artifact's {steps}-step chain with CFG at {SERVE_BATCH} labels (UNet batch "
        f"{2 * SERVE_BATCH}) and its decode: {chain_s:.2f} s wall ({1e3 * chain_s / steps:.2f} ms a step), K1 "
        f"launches {chain_launches}")
    log(f"export: K1 launches in the phase {launches}, all on the tensor-core route")
    del art
    torch.cuda.empty_cache()
    return launches, chain_s


def tone_clips(n: int, cfg, seed: int = 5) -> np.ndarray:
    """n clips of cfg.clip_seconds: two tones (random frequencies) and white noise, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.clip_samples) / cfg.sample_rate
    out = []
    for _ in range(n):
        f0, f1 = rng.uniform(200, 8000, 2)
        out.append(0.5 * np.sin(2 * np.pi * f0 * t) + 0.3 * np.sin(2 * np.pi * f1 * t)
                   + 0.05 * rng.standard_normal(t.size))
    return np.stack(out).astype(np.float32)


def phase_invert(torch, work: str) -> None:
    """The inversion chain at full width on the card against float64 on the CPU,
    its round trip and time; cli.spec_to_wav.run at batch 32."""
    from scipy.io import wavfile

    from spectrogramgenai_tpu_torch.audio.export import save_generated_pngs
    from spectrogramgenai_tpu_torch.audio.invert import db_mel_to_audio
    from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig, logmel_spectrogram
    from spectrogramgenai_tpu_torch.cli import spec_to_wav

    cfg = SpectrogramConfig()
    db = logmel_spectrogram(torch.from_numpy(tone_clips(32, cfg)).cuda(), cfg)  # (32, 256, 256) dB
    db27 = db[:SERVE_BATCH]
    wav = db_mel_to_audio(db27, cfg)
    torch.cuda.synchronize()
    check(wav.shape == (SERVE_BATCH, AUDIO_SAMPLES) and wav.dtype == torch.float32, f"waveforms {tuple(wav.shape)}")
    peaks = wav.abs().amax(dim=1)
    check(bool(torch.isfinite(wav).all()) and bool(((peaks - 1).abs() <= 1e-6).all()), "finite, each row's peak 1")

    # the card's float32 chain against float64 on the CPU, on two rows (each row is computed on its own)
    rows = db27[:2].double().cpu()
    short = db_mel_to_audio(db27, cfg, gl_iters=0)[:2].double().cpu()
    short64 = db_mel_to_audio(rows, cfg, gl_iters=0)
    rel_short = ((short - short64).norm() / short64.norm()).item()
    full64 = db_mel_to_audio(rows, cfg)
    rel_full = ((wav[:2].double().cpu() - full64).norm() / full64.norm()).item()
    db_card, db64 = (logmel_spectrogram(w.float(), cfg) for w in (wav[:2].cpu(), full64))
    full_db = (db_card - db64).abs().mean().item()
    log(f"invert: batch {SERVE_BATCH} × {cfg.n_mels} mels × {db.shape[-1]} frames, card float32 vs CPU float64 "
        f"(2 rows): waveform after 32 NNLS iterations and one synthesis rel {rel_short:.3g} "
        f"(≤ {INVERT_SHORT_REL}); after 32 + 32 "
        f"waveform rel {rel_full:.3g} (Griffin-Lim amplifies rounding), re-analysed log-mel mean |ΔdB| "
        f"{full_db:.4g} (≤ {INVERT_FULL_DB})")
    check(rel_short <= INVERT_SHORT_REL, f"invert: short chain vs float64 {rel_short:.3g} <= {INVERT_SHORT_REL}")
    check(full_db <= INVERT_FULL_DB, f"invert: full chain's log-mel vs float64 {full_db:.4g} dB <= {INVERT_FULL_DB}")

    # the round trip: re-analysed with the port's log-mel, against the input dB
    db2 = logmel_spectrogram(wav, cfg)[..., : db27.shape[-1]]
    db1 = db27[..., : db2.shape[-1]]
    mae = (db1 - db2).abs().mean().item()
    corr = float(np.corrcoef(db1.cpu().numpy().ravel(), db2.cpu().numpy().ravel())[0, 1])
    t_chain = cuda_ms(lambda: db_mel_to_audio(db27, cfg), runs=3, warmup=1)
    log(f"invert: round trip mean |ΔdB| {mae:.3f} (< {ROUNDTRIP_DB}), correlation {corr:.4f} (> {ROUNDTRIP_CORR}); "
        f"db_mel_to_audio at batch {SERVE_BATCH} {t_chain:.3f} ms (CUDA events, median of 3)")
    check(mae < ROUNDTRIP_DB and corr > ROUNDTRIP_CORR, f"invert round trip: {mae:.3f} dB, correlation {corr:.4f}")

    # cli.spec_to_wav on 32 viridis PNGs at batch 32: once to warm, then at 22,050 and 48,000 Hz
    specs = os.path.join(work, "specs")
    imgs = ((db.clamp(-80, 0) + 80.0) / 80.0 * 255.0).to(torch.uint8).cpu().numpy()
    save_generated_pngs(imgs, [os.path.join(specs, f"clip_{i:02d}.png") for i in range(len(imgs))])
    run_quiet(spec_to_wav.run, specs, os.path.join(work, "warm"), batch_size=32, device="cuda")
    for out_sr in (None, 48000):
        out_dir = os.path.join(work, f"wav_{out_sr or AUDIO_SR}")
        n, printed = run_quiet(spec_to_wav.run, specs, out_dir, batch_size=32, out_sr=out_sr, device="cuda")
        split = re.search(r"load ([\d.]+) s, NNLS ([\d.]+) s, Griffin-Lim ([\d.]+) s \(CUDA events\), resample "
                          r"([\d.]+) s, write ([\d.]+) s", printed)
        rate = re.search(r"in ([\d.]+)s \(([\d.]+) clips/s", printed)
        check(n == 32 and split is not None and rate is not None, f"spec_to_wav wrote {n} of 32 and its split")
        sr, data = wavfile.read(os.path.join(out_dir, "clip_00.wav"))
        check(sr == (out_sr or AUDIO_SR) and abs(len(data) - AUDIO_SAMPLES * sr / AUDIO_SR) <= 1,
              f"spec_to_wav output {sr} Hz, {len(data)} samples")
        log(f"spec_to_wav (batch 32, out_sr {out_sr or AUDIO_SR}): {rate.group(2)} clips/s; load {split.group(1)} s, "
            f"NNLS {split.group(2)} s, Griffin-Lim {split.group(3)} s (CUDA events), resample {split.group(4)} s, "
            f"write {split.group(5)} s")
    torch.cuda.empty_cache()


def phase_fid(torch) -> None:
    """tools/port_fid_batch.py with the sweep's best custom synth-0 classifier;
    the float32 features on the card against the CPU's."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import port_fid_batch

    from spectrogramgenai_tpu_torch.cli.fid import classifier_features, load_classifier
    from spectrogramgenai_tpu_torch.cli.inception_score import load_images

    ckpt = "sweep/ckpt_custom_synth0"
    pairs = ["val_vs_train:datasets/val:datasets/train", "val_vs_gen:datasets/val:gen_images",
             "self_val:datasets/val:datasets/val"]
    code, printed = run_quiet(port_fid_batch.main, ["--classifier_ckpt", ckpt, "--num_classes", str(TRAIN_CLASSES),
                                                    "--limit", "540", *pairs])
    for line in printed.splitlines():
        log(f"fid: {line}")
    check(code == 0, f"port_fid_batch exit code {code}")
    fids = {m.group(1): (float(m.group(2)), int(m.group(3)), int(m.group(4)))
            for m in re.finditer(r"FID\[(\w+)\] \(custom logit space\): (\S+)  \(n1=(\d+), n2=(\d+)\)", printed)}
    check(set(fids) == {"val_vs_train", "val_vs_gen", "self_val"}, f"three FIDs printed: {sorted(fids)}")
    for name in ("val_vs_train", "val_vs_gen"):
        check(math.isfinite(fids[name][0]) and fids[name][0] >= 0, f"FID[{name}] {fids[name][0]} finite, >= 0")
    check(abs(fids["self_val"][0]) <= FID_SELF_TOL, f"FID of val against itself {fids['self_val'][0]} near 0 "
                                                    f"(|·| <= {FID_SELF_TOL})")
    feats = re.search(r"features: (\d+) images in ([\d.]+) s \(([\d.]+) images/s", printed)
    check(feats is not None, "port_fid_batch printed its feature time")

    # the same checkpoint's float32 features, card against CPU, on 32 val images (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    imgs = load_images("datasets/val", 32)
    got, want = (classifier_features(imgs, classifier=load_classifier(ckpt, num_classes=TRAIN_CLASSES,
                                                                      compute_dtype="float32", device=dev))
                 for dev in ("cuda", "cpu"))
    err = float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))
    log(f"fid: FID val vs train {fids['val_vs_train'][0]:.4f}, val vs generated {fids['val_vs_gen'][0]:.4f}, "
        f"val vs itself {fids['self_val'][0]:.3g}; features {feats.group(1)} images in {feats.group(2)} s "
        f"({feats.group(3)} images/s: load, resize, bf16 forward); float32 features card vs CPU ({len(imgs)} images) "
        f"max error {err:.3g} of the largest logit (≤ {FEATURE_TOL})")
    check(got.shape == want.shape == (len(imgs), TRAIN_CLASSES) and err <= FEATURE_TOL,
          f"features card vs CPU {err:.3g} <= {FEATURE_TOL}")


def phase_acgan(torch, cfg=None) -> None:
    """cli.train_acgan.run on the card to its checkpoint at epoch 10, then one resumed epoch."""
    import copy
    import dataclasses

    from spectrogramgenai_tpu_torch.cli import train_acgan
    from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager
    from spectrogramgenai_tpu_torch.core.config import ACGANConfig, DataConfig, RunConfig
    from spectrogramgenai_tpu_torch.data.pipeline import ImageFolderSource, iterate_batches, to_device
    from spectrogramgenai_tpu_torch.train.acgan_task import ACGANTask

    # the ACGANConfig defaults: generator 512 → 32 channels, 256×256, noise 64 + 27, batch 16, bf16, RMSprop 0.002
    cfg = cfg or ACGANConfig(run=RunConfig(run_name="smoke_acgan", seed=0),
                             data=DataConfig(dataset_path="datasets", batch_size=16), num_classes=TRAIN_CLASSES,
                             epochs=ACGAN_EPOCHS + 1)
    steps_per_epoch = TRAIN_CLASSES * TRAIN_PER_CLASS // cfg.data.batch_size
    torch.cuda.reset_peak_memory_stats()
    t_run = time.perf_counter()
    (task, state), printed = run_quiet(train_acgan.run, cfg, device="cuda")
    wall = time.perf_counter() - t_run
    peak = torch.cuda.max_memory_allocated() / 2**30
    for line in printed.splitlines():
        log(f"acgan run 1: {line}")
    check(state.step == ACGAN_EPOCHS * steps_per_epoch, f"ACGAN trained {state.step} steps")
    epochs = re.findall(r"epoch (\d+): (\d+) steps in ([\d.]+) s, ([\d.]+) s/step, ([\d.]+) images/s, "
                        r"Loss_D (\S+), Loss_G (\S+), d_acc (\S+)", printed)
    check([int(e[0]) for e in epochs] == list(range(1, ACGAN_EPOCHS + 1)), "an ACGAN line for epochs 1 … 10")
    with open(f"results/{cfg.run.run_name}/training_results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    check([int(r["Epoch"]) for r in rows] == list(range(1, ACGAN_EPOCHS + 1)), "a CSV row per epoch")
    check(all(math.isfinite(float(r[k])) for r in rows for k in ("Loss_D", "Loss_G", "Loss_A"))
          and all(0.0 <= float(r["Loss_A"]) <= 1.0 for r in rows), "finite losses, d_acc in [0, 1]")
    check(all(os.path.exists(f"results/{cfg.run.run_name}/fake_samples_epoch_{e:03d}.png")
              for e in range(1, ACGAN_EPOCHS + 1)), "a sample grid per epoch")
    init = ACGANTask(cfg, "cpu").init_state()
    for i in range(task.generator.num_blocks):
        mean, var = (state.g_stats[f"block_{i}.bn1.running_{s}"].cpu() for s in ("mean", "var"))
        check(not torch.equal(mean, init.g_stats[f"block_{i}.bn1.running_mean"]) and not torch.equal(
            var, init.g_stats[f"block_{i}.bn1.running_var"]), f"block_{i}.bn1's running statistics moved")
    us = [k for k in state.d_stats if k.endswith(".u")]
    check(len(us) == 6 and all(not torch.equal(state.d_stats[k].cpu(), init.d_stats[k]) for k in us),
          "every spectral norm's u moved")
    norms = [float(state.d_stats[k].norm()) for k in us]
    check(all(abs(n - 1.0) < 1e-4 for n in norms), f"every u has unit norm ({min(norms):.6f} … {max(norms):.6f})")
    saved = CheckpointManager(f"models/{cfg.run.run_name}").restore(ACGAN_EPOCHS)
    for name, got, want in (("generator", saved["g_params"], {**state.g_params, **state.g_stats}),
                            ("discriminator", saved["d_params"], {**state.d_params, **state.d_stats})):
        check(set(got) == set(want) and all(torch.equal(got[k], want[k].cpu()) for k in want),
              f"the epoch-{ACGAN_EPOCHS} checkpoint holds the {name}'s state exactly")
    s_step, images_s = float(epochs[1][3]), float(epochs[1][4])
    log(f"acgan: {state.step} steps of batch {cfg.data.batch_size} (generator {cfg.noise_dim} + {cfg.num_classes} → "
        f"512 … 32 channels → 256×256, {cfg.compute_dtype}) in {wall:.2f} s wall (with sample grids and a "
        f"checkpoint); epoch 2 {s_step} s/step, {images_s} images/s (epoch 1 {epochs[0][3]} s/step); Loss_D "
        f"{rows[0]['Loss_D']} → {rows[-1]['Loss_D']}, Loss_G {rows[0]['Loss_G']} → {rows[-1]['Loss_G']}, d_acc "
        f"{rows[-1]['Loss_A']}; peak device memory {peak:.2f} GiB")

    # resume: one more epoch from the checkpoint of epoch 10, at its step
    (task2, state2), printed = run_quiet(train_acgan.run, dataclasses.replace(cfg, epochs=ACGAN_EPOCHS + 2),
                                         st_epochs=ACGAN_EPOCHS, device="cuda")
    for line in printed.splitlines():
        log(f"acgan run 2: {line}")
    check(f"resumed ACGAN from epoch {ACGAN_EPOCHS} (step {state.step})" in printed,
          f"the resumed run starts at the saved step {state.step}")
    check(state2.step == state.step + steps_per_epoch, f"resumed ACGAN run ended at step {state2.step}")
    check(CheckpointManager(f"models/{cfg.run.run_name}").all_steps() == [ACGAN_EPOCHS, ACGAN_EPOCHS + 1],
          "checkpoints of epochs 10 and 11")

    # one step's device time by kernel
    src = ImageFolderSource("datasets/train", seed=0, img_size=cfg.data.img_size)
    batch = to_device(next(iterate_batches(src, cfg.data.batch_size)), torch.device("cuda"))
    log_profile(torch, "acgan: one step", lambda: task2.train_step(state2, batch["image"], batch["label"]))

    # the trained nets' bf16 forward on the card against float32 on the CPU, the same weights
    gen = torch.Generator(device="cuda").manual_seed(1)
    z = task2.build_noise(torch.arange(cfg.data.batch_size, device="cuda") % cfg.num_classes, generator=gen)
    g_cpu = copy.deepcopy(task2.generator).to("cpu", torch.float32)
    g_cpu.load_state_dict({k: v.cpu() for k, v in {**state2.g_params, **state2.g_stats}.items()})
    d_cpu = copy.deepcopy(task2.discriminator).to("cpu", torch.float32)
    d_cpu.load_state_dict({k: v.cpu() for k, v in {**state2.d_params, **state2.d_stats}.items()})
    with torch.no_grad():
        fake_card, fake_cpu = task2.generate(state2, z).cpu(), g_cpu(z.cpu(), train=False)
        real = task2.preprocess(batch["image"])
        (rf_card, c_card), (rf_cpu, c_cpu) = task2.discriminator(real, train=False), d_cpu(real.cpu(), train=False)
    g_err = float((fake_card - fake_cpu).norm() / fake_cpu.norm())
    d_err = float((c_card.cpu() - c_cpu).norm() / c_cpu.norm())
    rf_err = float((rf_card.cpu() - rf_cpu).abs().max())
    log(f"acgan: bf16 forward on the card against float32 on the CPU (batch {cfg.data.batch_size}): generator "
        f"{g_err:.3g}, discriminator class log-probs {d_err:.3g} (relative L2, ≤ {GAN_BF16_TOL}), validity max "
        f"|Δ| {rf_err:.3g}")
    check(bool(torch.isfinite(fake_card).all()) and fake_card.shape == (cfg.data.batch_size, *real.shape[1:]),
          "finite samples of the data's shape")
    check(g_err <= GAN_BF16_TOL and d_err <= GAN_BF16_TOL, f"bf16 forwards within {GAN_BF16_TOL} of float32")
    del task, state, task2, state2, init, g_cpu, d_cpu
    torch.cuda.empty_cache()


def make_mix_corpus(work: str) -> tuple[str, str]:
    """SPECUNET_PAIRS noise and bird recordings of 7 s (every fourth at 44.1 kHz,
    the rest at 22,050 Hz; int16) and their CSVs (path, st, common_name)."""
    from scipy.io import wavfile

    wav_dir = os.path.join(work, "mix_wavs")
    os.makedirs(wav_dir)
    rng = np.random.default_rng(2)
    rows = {"noise": [], "bird": []}
    for i in range(SPECUNET_PAIRS):
        sr = 44100 if i % 4 == 0 else 22050
        t = np.arange(7 * sr) / sr
        wind = np.cumsum(rng.standard_normal(len(t)))
        noise = 0.3 * (wind - wind.mean()) / np.abs(wind).max() + 0.05 * rng.standard_normal(len(t))
        f0 = rng.uniform(1500, 5000)
        bird = sum(0.5 * np.sin(2 * np.pi * (f0 * (t - b) + 900 * (t - b) ** 2)) * ((t >= b) & (t < b + 0.8))
                   for b in rng.uniform(0, 6, 4))
        for kind, x in (("noise", noise), ("bird", bird + 0.01 * rng.standard_normal(len(t)))):
            path = os.path.join(wav_dir, f"{kind}{i:02d}.wav")
            wavfile.write(path, sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))
            rows[kind].append({"path": path, "st": repr(float(rng.uniform(0, 1))), "common_name": f"{kind}{i % 5}"})
    csvs = []
    for kind, table in rows.items():
        csvs.append(os.path.join(work, f"{kind}.csv"))
        with open(csvs[-1], "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["path", "st", "common_name"])
            writer.writeheader()
            writer.writerows(table)
    return csvs[0], csvs[1]


def exact_mel_check(torch, what: str, audio, cfg) -> None:
    """The exact mel kernel on ``audio`` (B, N) on the card at ``cfg``: against
    its plain version per element and, as log-mel over every frame, against
    the float64 oracle within the exact rung's dB bounds (per clip: the
    median within the typical bound, every clip within the adversarial
    one); kernel, plain and torch.stft + filterbank times (CUDA events,
    median of 10) and the bound."""
    import dataclasses

    from spectrogramgenai_tpu_torch.audio.mel import hann_window
    from spectrogramgenai_tpu_torch.audio.spectrogram import constants, reference_logmel_np
    from spectrogramgenai_tpu_torch.ops import mel_kernel as mk

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_mel_helpers import MEL_TOL, RUNG_BOUNDS, mel_rel_err

    b, n = audio.shape
    t_frames = cfg.frames_for(n)
    every_frame = dataclasses.replace(cfg, num_frames=t_frames)
    got = mk.fused_mel_power(audio, cfg, True)
    want = mk.mel_power_reference(audio, cfg, True)
    torch.cuda.synchronize()
    check(got.shape == (b, t_frames, cfg.n_mels), f"{what}: mel shape {tuple(got.shape)}")
    rel = mel_rel_err(got, want)
    oracle = np.stack([reference_logmel_np(c, every_frame) for c in audio.cpu().numpy()])
    err = np.abs(mk.logmel_from_power(got, every_frame).cpu().numpy() - oracle).max(axis=(1, 2))
    typical, adversarial = RUNG_BOUNDS[True]
    log(f"{what}: exact mel kernel ({b} × {n} samples → {t_frames} frames, n_fft {cfg.n_fft}, hop {cfg.hop_length}, "
        f"{cfg.n_mels} mels, centre {cfg.center}): kernel vs plain per element {rel:.4g} (≤ {MEL_TOL['exact']}); "
        f"log-mel vs float64 oracle, per clip max, sorted: " + " ".join(f"{e:.4g}" for e in np.sort(err)))
    check(rel <= MEL_TOL["exact"], f"{what}: mel kernel vs plain {rel:.4g} <= {MEL_TOL['exact']}")
    check(err.max() <= adversarial and float(np.median(err)) <= typical,
          f"{what}: log-mel vs oracle: max {err.max():.4g} <= {adversarial}, median {np.median(err):.4g} <= {typical}")

    window = torch.from_numpy(hann_window(cfg.n_fft)).cuda()
    fb_t = torch.from_numpy(np.ascontiguousarray(constants(cfg)[1].T)).cuda()

    def library():
        spec = torch.stft(audio, cfg.n_fft, cfg.hop_length, window=window, center=cfg.center, pad_mode="constant",
                          return_complex=True)
        return (spec.abs() ** 2).transpose(1, 2) @ fb_t

    t_k = cuda_ms(lambda: mk.fused_mel_power(audio, cfg, True))
    t_p = cuda_ms(lambda: mk.mel_power_reference(audio, cfg, True))
    t_lib = cuda_ms(library)
    consts = mk._kernel_constants(cfg, audio.device, "exact")
    flops = fft_mel_flops(b, t_frames, cfg.n_fft, int(consts[2][:, 1].sum().item()))
    nbytes = audio.nbytes + sum(c.nbytes for c in consts) + 4 * b * t_frames * cfg.n_mels
    t_flops, t_bytes = flops / H100_F64_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    log(f"{what}: exact mel kernel {b} × {n}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
        f"torch.stft + filterbank {t_lib:.3f} ms; bound {max(t_flops, t_bytes):.4f} ms (flops {flops:.4g} → "
        f"{t_flops:.4f} ms, bytes {nbytes:.4g} → {t_bytes:.4f} ms)")
    del got, want


def mix_kernel_check(torch, noise_csv: str, bird_csv: str) -> None:
    """The exact mel kernel at the mix shape (3 × SPECUNET_BATCH clips of 2¹⁷
    samples), before the midpoint normalisation (exact_mel_check)."""
    from spectrogramgenai_tpu_torch.audio.mix import mix_stack
    from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig
    from spectrogramgenai_tpu_torch.audio.wavio import fixed_window, load_wav
    from spectrogramgenai_tpu_torch.cli.train_specunet import WINDOW, read_rows

    cfg = SpectrogramConfig()
    noise_rows, bird_rows = read_rows(noise_csv), read_rows(bird_csv)
    clips = {"noise": [], "bird": []}
    for nr, br in list(zip(noise_rows, bird_rows))[:SPECUNET_BATCH]:
        for kind, row in (("noise", nr), ("bird", br)):
            clips[kind].append(fixed_window(load_wav(row["path"], target_sr=cfg.sample_rate)[0], cfg.sample_rate,
                                            br["st"], WINDOW))
    eps = np.random.default_rng(3).uniform(0.0, 0.3, SPECUNET_BATCH)
    stacked = mix_stack(np.stack(clips["noise"]), np.stack(clips["bird"]), eps)
    exact_mel_check(torch, "specunet: the mix shape", torch.from_numpy(stacked).cuda(), cfg)


def phase_specunet(torch, work: str, cfg=None) -> tuple[int, str]:
    """cli.train_specunet.run on the card: separate mode for 2 epochs, then
    denoise mode for 1; returns the exact mel kernel's launches of both runs
    (the main path) and the denoiser's checkpoint directory."""
    import dataclasses

    from spectrogramgenai_tpu_torch.cli import train_specunet
    from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager
    from spectrogramgenai_tpu_torch.core.config import DataConfig, RunConfig, SpecUNetConfig
    from spectrogramgenai_tpu_torch.ops.mel_kernel import fused_mel_power

    t0 = time.perf_counter()
    noise_csv, bird_csv = make_mix_corpus(work)
    log(f"specunet: {SPECUNET_PAIRS} noise and {SPECUNET_PAIRS} bird recordings of 7 s (a quarter at 44.1 kHz) "
        f"made in {time.perf_counter() - t0:.2f} s")
    mix_kernel_check(torch, noise_csv, bird_csv)

    # the SpecUNetConfig defaults: batch 8, bf16, Adam 1e-3; the denoiser d_model 512, 6 layers
    cfg = cfg or SpecUNetConfig(run=RunConfig(run_name="smoke_specunet", seed=0, log_every=1), epochs=2)
    steps_per_epoch = SPECUNET_PAIRS // cfg.data.batch_size
    launches = 0
    for mode, run_cfg in (("separate", cfg),
                          ("denoise", dataclasses.replace(cfg, run=dataclasses.replace(cfg.run, run_name="smoke_denoiser"),
                                                          mode="denoise", epochs=1))):
        torch.cuda.reset_peak_memory_stats()
        fused_mel_power.launches = 0  # the main path starts here
        t_run = time.perf_counter()
        (task, state), printed = run_quiet(train_specunet.run, run_cfg, noise_csv, bird_csv, device="cuda")
        wall = time.perf_counter() - t_run
        n_launch = fused_mel_power.launches  # the main path ends here
        launches += n_launch
        for line in printed.splitlines():
            log(f"specunet {mode}: {line}")
        steps = run_cfg.epochs * steps_per_epoch
        check(state.step == steps, f"specunet {mode} trained {state.step} of {steps} steps")
        check(n_launch >= steps, f"specunet {mode}: {n_launch} exact mel kernel launches >= {steps} batches")
        epochs = re.findall(r"epoch (\d+): (\d+) steps in ([\d.]+) s, ([\d.]+) s/step, train_mse (\S+); "
                            r"load/resample ([\d.]+) s, mel kernel ([\d.]+) s, normalise ([\d.]+) s, step ([\d.]+) s",
                            printed)
        check(len(epochs) == run_cfg.epochs and all(math.isfinite(float(e[4])) for e in epochs),
              f"specunet {mode}: {run_cfg.epochs} epoch lines with finite losses")
        records = [json.loads(line) for line in open(f"results/{run_cfg.run.run_name}/metrics.jsonl")]
        check(len(records) == steps and all(math.isfinite(r["train_mse"]) for r in records),
              f"specunet {mode}: {steps} finite logged losses")
        last = run_cfg.epochs - 1
        check(os.path.exists(f"results/{run_cfg.run.run_name}/sep_examples_epoch_{last:03d}.png"),
              f"specunet {mode}: separation figure")
        check(CheckpointManager(f"models/{run_cfg.run.run_name}").latest_step() == steps,
              f"specunet {mode}: checkpoint at step {steps}")
        e = epochs[-1]
        log(f"specunet {mode}: {steps} steps of batch {run_cfg.data.batch_size} ({run_cfg.compute_dtype}) in "
            f"{wall:.2f} s wall; epoch {e[0]} {e[3]} s/step ({e[1]} steps: load/resample {e[5]} s, mel kernel "
            f"{e[6]} s, normalise {e[7]} s, step {e[8]} s); {n_launch} exact mel kernel launches; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del task, state
    torch.cuda.empty_cache()
    return launches, "models/smoke_denoiser"


def phase_denoised_classifiers(torch, denoiser_ckpt: str, img_size: int = 256) -> None:
    """cli.train_classifiers with --denoiser_ckpt; the denoiser's float32 forward, card against CPU."""
    from spectrogramgenai_tpu_torch.cli import train_classifiers
    from spectrogramgenai_tpu_torch.data.pipeline import ImageFolderSource, iterate_batches
    from spectrogramgenai_tpu_torch.data.transforms import renorm_m1_1

    t0 = time.perf_counter()
    results, printed = run_quiet(train_classifiers.main, [
        "--train_dir", "datasets/train", "--val_dir", "datasets/val", "--models", "custom", "--synths", "0",
        "--epochs", "1", "--denoiser_ckpt", denoiser_ckpt, "--data.img_size", str(img_size),
        "--run.output_dir", "sweep_denoised", "--device", "cuda"])
    wall = time.perf_counter() - t0
    for line in printed.splitlines():
        log(f"denoised classifiers: {line}")
    lines = re.findall(r"custom_synth0 epoch 0: (\d+) steps in ([\d.]+) s, ([\d.]+) images/s, "
                       r"train_loss=([\d.naif]+) val_acc=([\d.]+)", printed)
    check(len(lines) == 1 and int(lines[0][0]) > 0 and math.isfinite(float(lines[0][3])),
          "the denoised custom run: a finite loss")
    log(f"denoised classifiers: custom with the denoiser, 1 epoch of {lines[0][0]} steps in {lines[0][1]} s "
        f"({lines[0][2]} images/s), {wall:.2f} s wall; val acc {results[('custom', 0)]:.4f}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    src = ImageFolderSource("datasets/val", img_size=img_size)
    x = renorm_m1_1(torch.from_numpy(next(iterate_batches(src, 8))["image"]))
    got = train_classifiers.load_denoiser_apply(denoiser_ckpt, "cuda")(x.cuda()).cpu()
    want = train_classifiers.load_denoiser_apply(denoiser_ckpt, "cpu")(x)
    err = float((got - want).abs().max() / max(1.0, float(want.abs().max())))
    log(f"denoised classifiers: the denoiser's float32 forward (8 × {img_size}×{img_size}, TF32 off) card vs CPU max error "
        f"{err:.3g} (≤ {DENOISER_TOL})")
    check(err <= DENOISER_TOL, f"denoiser card vs CPU {err:.3g} <= {DENOISER_TOL}")


def evaluator_weights(torch, weights_dir: str) -> dict:
    """JAX-layout checkpoints of seeded random port weights, written as
    tools/convert_*.py write theirs: inception_v3.msgpack, clap_audio.msgpack,
    resnet18_imagenet.msgpack and a manifest.json. Convolutions get He-scaled
    weights (normal, std √(2/fan_in)) so the deep ReLU nets keep O(1)
    activations; the CLAP BatchNorm gets log-mel-like statistics. Returns
    the state_dicts written."""
    from spectrogramgenai_tpu_torch.bridge import flax_from_state_dict
    from spectrogramgenai_tpu_torch.core import flax_msgpack
    from spectrogramgenai_tpu_torch.eval.clap import ClapAudioTower
    from spectrogramgenai_tpu_torch.eval.inception import InceptionV3
    from spectrogramgenai_tpu_torch.models.classifiers import ResNet18, reset_classifier

    os.makedirs(weights_dir, exist_ok=True)
    written = {}
    for i, (name, module) in enumerate((("inception_v3", InceptionV3()), ("clap_audio", ClapAudioTower()),
                                        ("resnet18_imagenet", ResNet18(num_classes=1000)))):
        reset_classifier(module, torch.Generator().manual_seed(100 + i))
        with torch.no_grad():
            for m in module.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.weight.mul_(math.sqrt(2.0))
            if name == "clap_audio":
                module.batch_norm.running_mean.fill_(-40.0)
                module.batch_norm.running_var.fill_(400.0)
        sd = module.state_dict()
        flax_msgpack.write(os.path.join(weights_dir, f"{name}.msgpack"), flax_from_state_dict(module, sd))
        written[name] = sd
    with open(os.path.join(weights_dir, "manifest.json"), "w") as f:
        json.dump({"inception_v3": {"sha256": "random-weights", "verified": False, "max_abs_forward_err": None}}, f)
    return written


def evaluator_audio(work: str) -> tuple[str, str]:
    """Two WAV directories at 22,050 Hz: "real", two 6-s clips of each class
    recording of the corpus (from 0 s and 30 s); "generated", cli.spec_to_wav
    of the generated PNGs."""
    from spectrogramgenai_tpu_torch.audio.wavio import load_wav, save_wav, slice_clip
    from spectrogramgenai_tpu_torch.cli import spec_to_wav

    real = os.path.join(work, "audio_real")
    for c in range(TRAIN_CLASSES):
        wav, sr = load_wav(os.path.join(work, "wavs", f"class{c:02d}.wav"))
        for begin in (0, 30):
            save_wav(os.path.join(real, f"class{c:02d}_{begin}.wav"), slice_clip(wav, sr, begin, begin + 3), sr)
    gen = os.path.join(work, "audio_gen")
    n, _ = run_quiet(spec_to_wav.run, "gen_images", gen, batch_size=32, device="cuda")
    check(n == len(os.listdir("gen_images")), f"spec_to_wav wrote {n} WAVs of the generated images")
    return real, gen


def timed_embeddings(torch, wavs: list, mode: str, model=None) -> tuple[np.ndarray, float, float]:
    """(embeddings, mel front end s, tower s): eval.fad's embeddings of 48-kHz
    ``wavs`` in ``mode`` batch by batch as eval.fad does, the two parts timed
    with CUDA events."""
    from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig
    from spectrogramgenai_tpu_torch.core.precision import full_float32
    from spectrogramgenai_tpu_torch.eval.clap import clap_input_features
    from spectrogramgenai_tpu_torch.ops.mel_kernel import fused_logmel

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    t_mel = t_tower = 0.0
    out = []
    if mode == "mel":
        cfg, n = SpectrogramConfig(sample_rate=48000), min(len(w) for w in wavs)
        stack = np.stack([w[:n] for w in wavs]).astype(np.float32)
        for i in range(0, len(stack), 32):
            (a, b) = events()
            a.record()
            spec = fused_logmel(torch.from_numpy(stack[i : i + 32]).cuda(), cfg, exact=True).double()
            emb = torch.cat([spec.mean(dim=2), spec.std(dim=2, correction=0)], dim=1).float()
            b.record()
            out.append(emb.cpu().numpy())
            t_mel += a.elapsed_time(b) / 1e3
        return np.concatenate(out), t_mel, 0.0
    with torch.no_grad(), full_float32():
        for i in range(0, len(wavs), 8):
            (a, b), (c, d) = events(), events()
            a.record()
            feats = clap_input_features(wavs[i : i + 8], model.cfg, "cuda")
            b.record()
            c.record()
            emb = model(feats)
            d.record()
            out.append(emb.cpu().numpy())
            t_mel, t_tower = t_mel + a.elapsed_time(b) / 1e3, t_tower + c.elapsed_time(d) / 1e3
    emb = np.concatenate(out)
    return emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12), t_mel, t_tower


def phase_evaluators(torch, work: str) -> tuple[int, tuple[str, str]]:
    """The evaluators through their CLIs with JAX-layout checkpoints of random
    port weights: cli.inception_score, cli.fid's Inception path, cli.fad (mel
    and clap modes, a directory against itself), cli.verify_metrics.run and
    cli.train_classifiers --pretrained_dir; the towers card against CPU; the
    exact mel kernel at the CLAP and FAD shapes. Returns the exact mel kernel's
    launches on the main path and the (real, generated) WAV directories."""
    from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig
    from spectrogramgenai_tpu_torch.cli import fad as fad_cli
    from spectrogramgenai_tpu_torch.cli import fid as fid_cli
    from spectrogramgenai_tpu_torch.cli import inception_score, train_classifiers, verify_metrics
    from spectrogramgenai_tpu_torch.core.config import ClassifierConfig
    from spectrogramgenai_tpu_torch.core.precision import full_float32
    from spectrogramgenai_tpu_torch.eval.clap import (
        ClapAudioTowerConfig,
        build_clap,
        clap_embeddings,
        load_clap_params,
        quantize_int16,
        repeatpad,
        spectrogram_config,
    )
    from spectrogramgenai_tpu_torch.eval.fad import embeddings_for_dir, load_audio_dir, mel_statistics_embeddings
    from spectrogramgenai_tpu_torch.eval.inception import build_inception, inception_inputs, load_inception_params
    from spectrogramgenai_tpu_torch.models.classifiers import ResNet18, reset_classifier
    from spectrogramgenai_tpu_torch.ops.mel_kernel import fused_mel_power
    from spectrogramgenai_tpu_torch.train.classifier_task import ClassifierTask

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    weights = "eval_weights"
    written = evaluator_weights(torch, weights)
    real_audio, gen_audio = evaluator_audio(work)
    n_real, n_gen = len(os.listdir(real_audio)), len(os.listdir(gen_audio))
    log(f"evaluators: 3 JAX-layout checkpoints of random weights and {n_real} real + {n_gen} generated WAVs "
        f"(22,050 Hz) made in {time.perf_counter() - t0:.2f} s")
    inc_path, clap_path = os.path.join(weights, "inception_v3.msgpack"), os.path.join(weights, "clap_audio.msgpack")

    fused_mel_power.launches = 0  # the main path starts here
    # the Inception Score and FID through their CLIs
    (is_mean, is_std), printed = run_quiet(inception_score.main, ["--image_dir", "gen_images", "--weights", inc_path])
    check(f"Inception Score: {is_mean:.4f} ± {is_std:.4f}  (n={len(os.listdir('gen_images'))})" in printed,
          "cli.inception_score printed its score")
    _, printed = run_quiet(fid_cli.main, ["--dir1", "datasets/val", "--dir2", "gen_images", "--weights", inc_path])
    m = re.search(r"^FID: (\S+)  \(n1=(\d+), n2=(\d+)\)$", printed.strip(), re.M)
    check(m is not None, f"cli.fid printed an FID: {printed!r}")
    fid = float(m.group(1))
    # FAD: mel mode, clap mode, a directory against itself
    fads = {}
    for name, args in (("mel", ["--mode", "mel"]), ("clap", ["--mode", "clap", "--clap_ckpt", clap_path])):
        fads[name], printed = run_quiet(fad_cli.main, ["--background_dir", real_audio, "--eval_dir", gen_audio, *args])
        check(printed.startswith(f"FAD ({name} embeddings"), f"cli.fad {name} printed its line: {printed!r}")
    fads["self"], _ = run_quiet(fad_cli.main, ["--background_dir", gen_audio, "--eval_dir", gen_audio, "--mode", "clap",
                                               "--clap_ckpt", clap_path])
    results, printed = run_quiet(verify_metrics.run, "datasets/val", "gen_images", weights, real_audio_dir=real_audio,
                                 gen_audio_dir=gen_audio, device="cuda")
    launches = fused_mel_power.launches  # the main path ends here
    for line in printed.splitlines():
        log(f"evaluators verify_metrics: {line}")
    log(f"evaluators: IS {is_mean:.4f} ± {is_std:.4f} ({m.group(3)} generated images), FID val vs generated {fid:.4f} "
        f"(n1 {m.group(2)}), FAD mel {fads['mel']:.6f}, clap {fads['clap']:.6f}, generated vs itself (clap) "
        f"{fads['self']!r}; verify_metrics {json.dumps(results)}; exact mel kernel launches {launches}")
    check(is_mean >= 1.0 - 1e-12 and math.isfinite(is_mean), f"IS {is_mean} finite, >= 1 (to float64 rounding)")
    for name, value in (("FID", fid), ("FAD mel", fads["mel"]), ("FAD clap", fads["clap"]),
                        *((f"verify_metrics {k}", v) for k, v in results.items())):
        check(math.isfinite(value) and value >= 0, f"{name} {value} finite, >= 0")
    check(fads["self"] <= EVAL_SELF_FAD_TOL,
          f"FAD of a directory against itself {fads['self']!r} <= {EVAL_SELF_FAD_TOL}")
    same = [(results["inception_score_mean"], is_mean), (results["fid"], fid), (results["fad"], fads["clap"])]
    check(all(math.isclose(a, b, rel_tol=1e-3, abs_tol=1e-6) for a, b in same),
          f"verify_metrics gives the CLIs' scores: {same}")

    # rates: images/s with the load/resize and forward split; clips/s with load/resample, mel kernel, tower
    t = time.perf_counter()
    images = inception_score.load_images("gen_images")
    t_load = time.perf_counter() - t
    model = build_inception(load_inception_params(inc_path), "cuda", fid_pool=True)
    fid_cli.compute_features(images, model=model)  # warm-up
    t = time.perf_counter()
    fid_cli.compute_features(images, model=model)
    t_fwd = time.perf_counter() - t
    log(f"evaluators: Inception {len(images)} images: load/resize {t_load:.3f} s "
        f"({len(images) / t_load:.1f} images/s), "
        f"forward {t_fwd:.3f} s ({len(images) / t_fwd:.1f} images/s, batch 32, float32, TF32 off); end to end "
        f"{len(images) / (t_load + t_fwd):.1f} images/s")
    clap = build_clap(load_clap_params(clap_path), "cuda")
    for mode in ("mel", "clap"):
        # end to end through eval.fad's entry (the clap mode reads its checkpoint too), on the host clock
        t = time.perf_counter()
        entry = embeddings_for_dir(gen_audio, mode, 48000, clap_ckpt=clap_path, device="cuda")
        torch.cuda.synchronize()
        t_entry = time.perf_counter() - t
        # the split: load/resample on the host clock, the front end and the tower with CUDA events
        t = time.perf_counter()
        wavs = load_audio_dir(gen_audio, 48000)
        t_load = time.perf_counter() - t
        emb, t_mel, t_tower = timed_embeddings(torch, wavs, mode, clap)
        log(f"evaluators: FAD {mode} embeddings of {len(wavs)} clips: eval.fad.embeddings_for_dir {t_entry:.3f} s, "
            f"{len(wavs) / t_entry:.1f} clips/s end to end; split: load/resample {t_load:.3f} s, "
            f"mel front end {t_mel:.4f} s, tower {t_tower:.4f} s (CUDA events)")
        want = mel_statistics_embeddings(wavs, 48000) if mode == "mel" else clap_embeddings(wavs, model=clap)
        check(np.allclose(emb, want, rtol=1e-5, atol=1e-6) and np.allclose(entry, want, rtol=1e-5, atol=1e-6),
              f"the timed {mode} loop and embeddings_for_dir give eval.fad's embeddings")

    # the towers, card against CPU, the same weights, float32 with TF32 off
    x = inception_inputs(images[:8], "cpu")
    errs = {}
    for fid_pool, what in ((False, "logits"), (True, "features")):
        card_model = build_inception(load_inception_params(inc_path), "cuda", fid_pool=fid_pool)
        cpu_model = build_inception(load_inception_params(inc_path), "cpu", fid_pool=fid_pool)
        with torch.no_grad(), full_float32():
            got, want = card_model(x.cuda(), return_features=fid_pool).cpu(), cpu_model(x, return_features=fid_pool)
        errs[f"Inception {what}"] = float((got - want).norm() / want.norm())
    two = wavs[:2]
    got = clap_embeddings(two, model=clap, normalize=False)
    want = clap_embeddings(two, load_clap_params(clap_path), device="cpu", normalize=False)
    errs["CLAP embeddings"] = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    log("evaluators: card vs CPU (float32, TF32 off; relative L2): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" (≤ {TOWER_TOL}; 8 images, 2 clips)")
    check(all(v <= TOWER_TOL for v in errs.values()), f"towers card vs CPU within {TOWER_TOL}: {errs}")

    # cli.train_classifiers --pretrained_dir: one epoch of ResNet18 from the converted file
    results_pre, printed = run_quiet(train_classifiers.main, [
        "--train_dir", "datasets/train", "--val_dir", "datasets/val", "--models", "resnet", "--synths", "0",
        "--epochs", "1", "--pretrained_dir", weights, "--run.output_dir", "sweep_pretrained", "--device", "cuda"])
    for line in printed.splitlines():
        log(f"evaluators pretrained: {line}")
    n_file = sum(1 for k in written["resnet18_imagenet"] if not k.startswith("fc.") and "running" not in k)
    check(f"resnet: loaded {n_file} pretrained tensors from {weights}/resnet18_imagenet.msgpack" in printed,
          f"ResNet18 loaded its {n_file} non-head parameters from the file")
    task = ClassifierTask(ClassifierConfig(model_name="resnet", num_classes=TRAIN_CLASSES), "cpu")
    merged, _ = task.pretrained_variables(os.path.join(weights, "resnet18_imagenet.msgpack"))
    fresh = reset_classifier(ResNet18(TRAIN_CLASSES), torch.Generator().manual_seed(task.cfg.run.seed)).state_dict()
    check(torch.equal(merged["fc.weight"], fresh["fc.weight"]) and torch.equal(merged["fc.bias"], fresh["fc.bias"]),
          "the head is the fresh seeded init")
    saved = torch.load("sweep_pretrained/ckpt_resnet_synth0/best/state.pt", weights_only=True)["params"]
    frozen = [k for k, flag in task.mask.items() if not flag]
    check(all(torch.equal(saved[k], written["resnet18_imagenet"][k]) for k in frozen),
          f"ResNet18's {len(frozen)} frozen tensors are the file's after an epoch")
    log(f"evaluators pretrained: ResNet18 val acc {results_pre[('resnet', 0)]:.4f} after 1 epoch from the file; "
        f"{len(frozen)} frozen tensors bit-equal to the file's, the head fresh")

    # the exact mel kernel at the two new shapes
    cfg_clap = ClapAudioTowerConfig()
    clips = np.stack([repeatpad(quantize_int16(w), cfg_clap.max_length_s * cfg_clap.sampling_rate) for w in wavs[:8]])
    audio = torch.nn.functional.pad(torch.from_numpy(clips).cuda(), (512, 512), mode="reflect").contiguous()
    exact_mel_check(torch, "evaluators: the CLAP shape", audio, spectrogram_config(cfg_clap))
    n = min(len(w) for w in wavs[:32])
    audio = torch.from_numpy(np.stack([w[:n] for w in wavs[:32]]).astype(np.float32)).cuda()
    exact_mel_check(torch, "evaluators: the FAD mel shape", audio, SpectrogramConfig(sample_rate=48000))
    log(f"evaluators: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, clap, audio
    torch.cuda.empty_cache()
    return launches, (real_audio, gen_audio)


def hf_clap_state_dict(module) -> dict:
    """A port CLAP tower's weights as HF ClapAudioModelWithProjection's
    state_dict: tools/port_convert_clap.py's key mapping inverted. The port's
    torch layouts are HF's, so only the names change."""
    renames = ((r"^layers_(\d+)_blocks_(\d+)\.", r"layers.\1.blocks.\2."),
               (r"^layers_(\d+)_downsample\.", r"layers.\1.downsample."),
               (r"^patch_embed_(proj|norm)\.", r"patch_embed.\1."),
               (r"\.attention\.(query|key|value|relative_position_bias_table)", r".attention.self.\1"),
               (r"\.attention\.out\.", ".attention.output.dense."),
               (r"\.(intermediate|output)\.(weight|bias)$", r".\1.dense.\2"))
    out = {}
    for k, v in module.state_dict().items():
        if k.startswith(("linear1.", "linear2.")):
            out["audio_projection." + k] = v
            continue
        for pattern, repl in renames:
            k = re.sub(pattern, repl, k)
        out["audio_model.audio_encoder." + k] = v
    return out


def flat_tree(tree: dict, prefix: tuple = ()) -> dict:
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        out.update(flat_tree(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def same_tree(got: dict, want: dict) -> bool:
    """The same paths, and at each the same dtype, shape and values."""
    got, want = flat_tree(got), flat_tree(want)
    return set(got) == set(want) and all(
        np.asarray(got[k]).dtype == np.asarray(want[k]).dtype and np.array_equal(got[k], want[k]) for k in want)


@contextlib.contextmanager
def hidden_module(name: str):
    """``import name`` (and its submodules) fails inside the block, as where it is not installed."""
    saved = {m: sys.modules.pop(m) for m in list(sys.modules) if m == name or m.startswith(name + ".")}
    sys.modules[name] = None
    try:
        yield
    finally:
        del sys.modules[name]
        sys.modules.update(saved)


def phase_provision(torch, audio: tuple[str, str]) -> int:
    """tools/port_provision_eval_weights.py on the card into eval_provisioned/:
    seeded random tests/torch_refs.py InceptionV3 and ResNet18 (1000 classes)
    converted, verified on cuda and installed, each file read back bit-equal
    to the converted tree; an HF-layout CLAP state_dict of a random port tower
    refused without --skip_verify while transformers is hidden and installed
    with it, then, where transformers is installed, verified against its
    tower on the card; then cli.verify_metrics.run (IS, FID, CLAP-FAD from those files) and one
    epoch of cli.train_classifiers --pretrained_dir eval_provisioned. Returns
    the exact mel kernel's launches on the main path."""
    for sub in ("tools", "tests"):
        sys.path.insert(0, os.path.join(REPO, sub))
    import port_provision_eval_weights as prov
    from port_convert_torchvision import CONVERTERS, load_state_dict
    from torch_refs import TorchInceptionV3, TorchResNet18, randomize_

    from spectrogramgenai_tpu_torch.bridge import flax_from_state_dict, state_dict_from_flax
    from spectrogramgenai_tpu_torch.cli import train_classifiers, verify_metrics
    from spectrogramgenai_tpu_torch.core.config import ClassifierConfig
    from spectrogramgenai_tpu_torch.eval.clap import ClapAudioTower, load_clap_params
    from spectrogramgenai_tpu_torch.eval.inception import load_inception_params
    from spectrogramgenai_tpu_torch.models.classifiers import ResNet18, reset_classifier
    from spectrogramgenai_tpu_torch.ops.mel_kernel import fused_mel_power
    from spectrogramgenai_tpu_torch.train.classifier_task import ClassifierTask

    out, src = "eval_provisioned", "provision_sources"
    os.makedirs(src, exist_ok=True)
    for name, cls in (("inception_v3", TorchInceptionV3), ("resnet18", TorchResNet18)):
        path = os.path.join(src, f"{name}.pth")
        # the convolutions scaled by 2√2 against randomize_'s BatchNorm scales of ~0.5 and the ReLUs, so that
        # activations stay O(1) through the depth and the scores below are not those of a constant net
        sd = randomize_(cls(num_classes=1000), seed=5).state_dict()
        torch.save({k: v * (2 * math.sqrt(2)) if v.ndim == 4 else v for k, v in sd.items()}, path)
        t = time.perf_counter()
        manifest, printed = run_quiet(prov.main, [f"--{name}", path, "--out_dir", out])
        secs = time.perf_counter() - t
        entry = manifest[name]
        for line in printed.splitlines():
            log(f"provision: {line}")
        check(entry["verified"] is True and entry["max_abs_forward_err"] <= prov.ATOL,
              f"{name} verified on the card, max-abs error {entry['max_abs_forward_err']!r} <= {prov.ATOL}")
        want = CONVERTERS[name](load_state_dict(path))
        if name == "inception_v3":
            check(same_tree(load_inception_params(entry["path"]), want),
                  "load_inception_params reads the converted tree bit-equal")
        else:
            task = ClassifierTask(ClassifierConfig(model_name="resnet", num_classes=TRAIN_CLASSES), "cpu")
            merged, n_used = task.pretrained_variables(entry["path"])
            ref = state_dict_from_flax(ResNet18(1000), want)
            body = [k for k in ref if not k.startswith("fc.")]
            n_resnet = len(flat_tree(want["params"])) - 2
            check(n_used == n_resnet and all(torch.equal(merged[k], ref[k]) for k in body),
                  f"pretrained_variables takes {n_used} of the file's parameters (want {n_resnet}), "
                  f"every non-head tensor bit-equal to the converted tree")
        log(f"provision: {name} (1000 classes) converted, verified on the card (float32, TF32 off, 2 × 96×96) "
            f"and installed in {secs:.2f} s: max-abs logit error {entry['max_abs_forward_err']:.3g}, "
            f"{os.path.getsize(entry['path']) / 1e6:.1f} MB → {entry['path']}")

    # CLAP: its forward check needs transformers; hidden, as where it is not installed, CLAP is refused
    tower = ClapAudioTower()
    reset_classifier(tower, torch.Generator().manual_seed(104))
    start = flax_from_state_dict(tower, tower.state_dict())
    path = os.path.join(src, "clap_pytorch_model.bin")
    torch.save(hf_clap_state_dict(tower), path)
    clap_file = os.path.join(out, "clap_audio.msgpack")
    with hidden_module("transformers"):
        try:
            run_quiet(prov.main, ["--clap", path, "--out_dir", out])
            refused = ""
        except RuntimeError as e:
            refused = str(e)
        check("--skip_verify" in refused and not os.path.exists(clap_file),
              f"CLAP without transformers and without --skip_verify is refused, nothing installed: {refused!r}")
        t = time.perf_counter()
        manifest, _ = run_quiet(prov.main, ["--clap", path, "--out_dir", out, "--skip_verify"])
        secs = time.perf_counter() - t
    check(manifest["clap"]["verified"] is False and "max_abs_forward_err" not in manifest["clap"],
          "the manifest records CLAP as unverified")
    check(same_tree(load_clap_params(clap_file), start), "the installed CLAP file holds the starting tree bit-equal")
    log(f"provision: CLAP without transformers refused without --skip_verify ({refused}); with it converted and "
        f"installed in {secs:.2f} s, {os.path.getsize(clap_file) / 1e6:.1f} MB, the starting tree bit-equal")
    if importlib.util.find_spec("transformers") is None:
        log("provision: transformers is not installed here, so CLAP stays unverified")
    else:  # the HF tower on the card against the port's (HTSAT-tiny, float32, TF32 off)
        import transformers

        t = time.perf_counter()
        manifest, _ = run_quiet(prov.main, ["--clap", path, "--out_dir", out])
        secs, err = time.perf_counter() - t, manifest["clap"]["max_abs_forward_err"]
        check(manifest["clap"]["verified"] is True and err <= prov.ATOL,
              f"CLAP verified against transformers' tower on the card, max-abs error {err!r} <= {prov.ATOL}")
        check(same_tree(load_clap_params(clap_file), start), "the verified CLAP file holds the starting tree")
        log(f"provision: CLAP verified against transformers {transformers.__version__}'s "
            f"ClapAudioModelWithProjection (1 × 1001 frames) and installed in {secs:.2f} s: max-abs embedding "
            f"error {err:.3g}")

    # the evaluators and --pretrained_dir from the provisioned directory
    fused_mel_power.launches = 0  # the main path starts here
    results, printed = run_quiet(verify_metrics.run, "datasets/val", "gen_images", out, real_audio_dir=audio[0],
                                 gen_audio_dir=audio[1], device="cuda")
    launches = fused_mel_power.launches  # the main path ends here
    for line in printed.splitlines():
        log(f"provision verify_metrics: {line}")
    inc = manifest["inception_v3"]
    check(f"inception_v3: sha256={inc['sha256'][:12]}… verified=True" in printed and "WARNING" not in printed,
          "verify_metrics names the provisioned InceptionV3 and warns of no random weights")
    check(set(results) == {"inception_score_mean", "inception_score_std", "fid", "fad"}
          and all(math.isfinite(v) and v >= 0 for v in results.values()) and results["inception_score_mean"] >= 1.0 - 1e-12,
          f"IS >= 1, FID and FAD finite and >= 0: {results}")
    check(launches > 0, f"the CLAP front end launched the exact mel kernel ({launches})")
    _, printed = run_quiet(train_classifiers.main, [
        "--train_dir", "datasets/train", "--val_dir", "datasets/val", "--models", "resnet", "--synths", "0",
        "--epochs", "1", "--pretrained_dir", out, "--run.output_dir", "sweep_provisioned", "--device", "cuda"])
    loaded = f"resnet: loaded {n_resnet} pretrained tensors from {out}/resnet18_imagenet.msgpack"
    check(loaded in printed, f"train_classifiers --pretrained_dir {out}: {loaded!r}")
    log(f"provision: verify_metrics {json.dumps(results)} from {out}/ (exact mel kernel launches {launches}); "
        f"cli.train_classifiers --pretrained_dir: {loaded}")
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
    with counted_decode() as decode:
        (task, state), printed = run_quiet(train_vqvae.run, cfg, device="cuda")
    wall = time.perf_counter() - t_run
    peak = torch.cuda.max_memory_allocated() / 2**30
    for line in printed.splitlines():
        log(f"train_vqvae run 1: {line}")
    log_decode("train_vqvae run 1", decode)
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
                      epochs: int = 2) -> list[str]:
    """Generated images from the trained DDPM, then the classifier sweep on
    real + synthetic images and its evaluation, through the CLIs; one train
    step each of the nets the sweep does not train here. Returns the sweep's
    flags but its nets, counts and output directory."""
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
    with counted_decode() as decode:
        results, printed = run_quiet(train_classifiers.main, ["--train_dir", "datasets/train", "--gen_dir",
                                                              "gen_images", "--epochs", str(epochs), *common])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    for line in printed.splitlines():
        log(f"classifiers sweep: {line}")
    log_decode("classifiers sweep", decode)
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
    check(len(os.listdir("eval")) == 9, "eval_results.csv, four classification reports and four confusion PNGs")
    # each confusion PNG: a viridis block per cell, scaled from the matrix's min to its max
    for model, synth in ((m, s) for m in ("custom", "resnet") for s in synths):
        with open(f"eval/{model}_synth{synth}_confusion_matrix.png", "rb") as f:
            px = png_rgb(f.read())
        cell = 256 // TRAIN_CLASSES
        check(px.shape == (TRAIN_CLASSES * cell, TRAIN_CLASSES * cell, 3), f"confusion PNG {px.shape}")
        blocks = px.reshape(TRAIN_CLASSES, cell, TRAIN_CLASSES, cell, 3)
        check(bool((blocks == blocks[:, :1, :, :1]).all()), "one colour a confusion cell")
        idx = viridis_index(blocks[:, 0, :, 0])
        check(idx.min() == 0 and idx.max() == 255, "the confusion PNG spans the scale, min to max")
    log(f"classifiers eval: 4 confusion PNGs of {TRAIN_CLASSES}×{TRAIN_CLASSES} cells, {256 // TRAIN_CLASSES} px a "
        f"cell, viridis from min to max")
    return ["--train_dir", "datasets/train", "--gen_dir", "gen_images", "--epochs", str(epochs), "--val_dir",
            "datasets/val", "--test_dir", "datasets/val", "--data.img_size", str(img_size), "--data.batch_size",
            str(batch_size)]


def phase_train(torch, vqae_ckpt: str) -> tuple[tuple[int, int], object, float]:
    """cli.train_ddpm.run on the card from the VQ-VAE checkpoint ``vqae_ckpt``,
    resumed once; returns the forward and backward kernel launches of the
    first run (the main path), the config and its s/step after epoch 0."""
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
    return launches, cfg, s_per_step


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


PARALLEL_STEPS = TRAIN_CLASSES * TRAIN_PER_CLASS // TRAIN_BATCH  # one epoch of the train phase's corpus


def run_cli(module: str, args: list[str], ranks: int | None = None) -> tuple[str, float]:
    """``python -m module args`` in a fresh process, or under
    ``python -m torch.distributed.run --standalone --nproc_per_node ranks``;
    returns (its standard output, its wall seconds). Fatal if it fails."""
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(ranks)] \
        if ranks else [sys.executable]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, (REPO, os.environ.get("PYTHONPATH"))))}
    t0 = time.perf_counter()
    proc = subprocess.run([*launch, "-m", module, *args], capture_output=True, text=True, env=env, timeout=900)
    check(proc.returncode == 0, f"{' '.join(launch[-3:] if ranks else [])} {module} exited {proc.returncode}:\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout, time.perf_counter() - t0


def rank_report(printed: str, what: str) -> dict:
    """The one rank's ``rank {...}`` JSON line (cli.common.report_rank)."""
    lines = [json.loads(line[len("rank "):]) for line in printed.splitlines() if line.startswith("rank {")]
    check(len(lines) == 1, f"{what}: one rank line, got {len(lines)}")
    return lines[0]


def same_checkpoint(torch, want_path: str, got_path: str, what: str) -> int:
    """Every tensor of two checkpoint files bit-equal; returns how many."""
    want = torch.load(want_path, map_location="cpu", weights_only=True)
    got = torch.load(got_path, map_location="cpu", weights_only=True)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix[:-1], tree

    a, b = dict(leaves(want)), dict(leaves(got))
    check(a.keys() == b.keys(), f"{what}: the same tensors")
    diff = [k for k in a if not torch.equal(a[k], b[k])]
    worst = max((float((a[k].double() - b[k].double()).abs().max()) for k in diff), default=0.0)
    check(not diff, f"{what}: bit-equal to the run without torchrun; {len(diff)} of {len(a)} tensors differ "
                    f"(max |Δ| {worst:.3g}; first {diff[:4]})")
    return len(a)


def trace_collectives(path: str) -> dict:
    """From a torch.profiler Chrome trace: the device kernels' total time, the
    NCCL kernels' count and time, and the collective calls (c10d / nccl ops)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    nccl = [e for e in kernels if "nccl" in e.get("name", "").lower()]
    calls = [e for e in events if e.get("cat") == "cpu_op"
             and (e.get("name", "").startswith(("c10d::", "nccl:")) or e.get("name") == "record_param_comms")]
    by_name: dict[str, int] = {}
    for e in calls:
        by_name[e["name"]] = by_name.get(e["name"], 0) + 1
    return {"kernel_ms": sum(e.get("dur", 0) for e in kernels) / 1e3, "nccl_kernels": len(nccl),
            "nccl_ms": sum(e.get("dur", 0) for e in nccl) / 1e3, "calls": by_name}


def phase_parallel(torch, cfg, plain_s_per_step: float) -> dict[str, int]:
    """cli.train_ddpm under torchrun (NCCL, one rank) in replicate and fsdp
    with the train phase's configuration ``cfg``: each checkpoint against the
    train phase's own run of it; returns the ranks' attention launches."""
    ddpm = "spectrogramgenai_tpu_torch.cli.train_ddpm"
    args = ["--data.dataset_path", cfg.data.dataset_path, "--data.batch_size", str(cfg.data.batch_size),
            "--vqae_ckpt", cfg.vqae_ckpt, "--epochs", str(cfg.epochs), "--log_every_epoch", str(cfg.log_every_epoch),
            "--run.seed", str(cfg.run.seed), "--run.log_every", str(cfg.run.log_every)]  # one checkpoint, the last
    steps = cfg.epochs * PARALLEL_STEPS
    launches = {"attention_fwd": 0, "attention_bwd": 0}
    for mode in ("replicate", "fsdp"):
        extra = ["--profile_dir", "par_profile"] if mode == "fsdp" else []
        printed, wall = run_cli(ddpm, [*args, "--run.run_name", f"par_{mode}", "--run.param_sharding", mode, *extra],
                                ranks=1)
        rank = rank_report(printed, f"train_ddpm {mode}")
        epochs = re.findall(r"epoch (\d+): (\d+) steps in ([\d.]+) s, ([\d.]+) s/step", printed)
        check(len(epochs) == cfg.epochs and all(int(e[1]) == PARALLEL_STEPS for e in epochs), f"{mode}: epoch lines")
        calls, kern = rank["collectives"], rank["kernels"]
        check(rank["backend"] == "nccl" and rank["mesh"] == {"data": 1, "model": 1} and rank["device"] == "cuda:0",
              f"{mode}: one NCCL rank on cuda:0 ({rank})")
        check(calls.get("all_reduce", 0) >= steps, f"{mode}: a gradient bucket every step ({calls})")
        if mode == "fsdp":
            check(calls.get("reduce_scatter", 0) >= steps and calls.get("all_gather", 0) >= steps,
                  f"fsdp: reduce-scatter and all-gather every step ({calls})")
        else:
            check(calls.get("reduce_scatter", 0) == 0, f"replicate: no reduce-scatter ({calls})")
        check(kern["attention_fwd"] >= 3 * steps and kern["attention_fwd_mma"] == kern["attention_fwd"]
              and kern["attention_bwd"] >= 3 * steps,
              f"{mode}: K1 on the tensor-core route and K1b inside the rank, ≥ {3 * steps} each ({kern})")
        launches["attention_fwd"] += kern["attention_fwd"]
        launches["attention_bwd"] += kern["attention_bwd"]
        step_dir = f"step_{steps:010d}"
        n = same_checkpoint(torch, f"models/{cfg.run.run_name}/{step_dir}/state.pt",
                            f"models/par_{mode}/{step_dir}/state.pt", f"train_ddpm {mode}")
        log(f"parallel: torchrun train_ddpm --run.param_sharding {mode}: {steps} steps of batch {cfg.data.batch_size}, "
            f"epoch 1 {epochs[1][3]} s/step{' (traced by --profile_dir)' if extra else ''} against "
            f"{plain_s_per_step:.4f} in the train phase's run without a process group (epoch 0 {epochs[0][3]}); "
            f"{wall:.1f} s for the process; rank line {json.dumps(rank)}; the checkpoint of step {steps} bit-equal "
            f"to the train phase's ({n} tensors)")
    trace = trace_collectives(os.path.join("par_profile", "trace.json"))
    log(f"parallel: the fsdp run's trace (the whole run: cache encode, {steps} steps, validation, previews): "
        f"{trace['nccl_kernels']} NCCL kernels, {trace['nccl_ms']:.3f} ms of {trace['kernel_ms']:.1f} ms device "
        f"kernel time ({100 * trace['nccl_ms'] / max(trace['kernel_ms'], 1e-9):.3f} %, "
        f"{trace['nccl_ms'] / steps:.3f} ms a step); collective calls {trace['calls']}")
    return launches


def phase_parallel_classifier(torch, args: list[str]) -> None:
    """The classifier sweep's ResNet18 synth-0 run (``args``, the sweep's
    flags) again under torchrun (NCCL, one rank) with fsdp: its best
    checkpoint, BatchNorm statistics included, against the sweep's."""
    clf = "spectrogramgenai_tpu_torch.cli.train_classifiers"
    printed, wall = run_cli(clf, [*args, "--models", "resnet", "--synths", "0", "--run.output_dir", "par_clf",
                                  "--run.param_sharding", "fsdp"], ranks=1)
    rank = rank_report(printed, "train_classifiers fsdp")
    calls = rank["collectives"]
    check(rank["backend"] == "nccl" and calls.get("reduce_scatter", 0) > 0 and calls.get("all_gather", 0) > 0,
          f"classifiers fsdp: NCCL reduce-scatter and all-gather ({rank})")
    n = same_checkpoint(torch, "sweep/ckpt_resnet_synth0/best/state.pt", "par_clf/ckpt_resnet_synth0/best/state.pt",
                        "train_classifiers fsdp")
    epochs = [x for x in printed.splitlines() if x.startswith("resnet_synth0 epoch")]
    log(f"parallel: torchrun train_classifiers resnet --run.param_sharding fsdp: {'; '.join(epochs)}; {wall:.1f} s "
        f"for the process; rank line {json.dumps(rank)}; best checkpoint bit-equal to the sweep's ({n} tensors, "
        f"BatchNorm statistics included)")


def phase_figures(torch) -> None:
    """The experiment's two figures, without matplotlib or PIL, from the
    smoke's own images and the classifier sweep's results."""
    import glob
    import shutil

    from spectrogramgenai_tpu_torch.audio.export import decode_png_rgb

    exp = "figure_exp"
    for i in range(3):
        real = sorted(glob.glob(f"datasets/train/class{i:02d}/*.png"))[0]
        gen = f"gen_images/class{i:02d}_gen_imgs_{i}_0.png"
        os.makedirs(f"{exp}/datasets/train/species{i:02d}", exist_ok=True)
        shutil.copy(real, f"{exp}/datasets/train/species{i:02d}/")
        for d in ("gen_images", "gen_images_chain"):  # the smoke runs no 999-step chain to images: the dpmpp ones
            os.makedirs(f"{exp}/{d}", exist_ok=True)
            shutil.copy(gen, f"{exp}/{d}/species{i:02d}_gen_imgs_{i}_0.png")
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import port_analyse_results
    import port_make_experiment_figure

    t0 = time.perf_counter()
    _, printed = run_quiet(port_make_experiment_figure.main, ["--exp", exp, "--classes", "0,1,2", "--out",
                                                              "figures/real_vs_generated.png"])
    fig = decode_png_rgb(open("figures/real_vs_generated.png", "rb").read())
    check(fig.shape == (18 + 6 + 3 * 198, 6 + 3 * 198, 3), f"the comparison figure's size {fig.shape}")
    wall_fig = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, printed = run_quiet(port_analyse_results.main, ["--results_dir", "sweep", "--out_dir", "figures"])
    plot = decode_png_rgb(open("figures/acc_vs_synth.png", "rb").read())
    check(plot.shape == (500, 700, 3), f"acc_vs_synth.png's size {plot.shape}")
    log(f"figures: real_vs_generated.png {fig.shape[1]}x{fig.shape[0]} in {wall_fig:.2f} s, acc_vs_synth.png "
        f"{plot.shape[1]}x{plot.shape[0]} from {printed.strip()!r} in {time.perf_counter() - t0:.2f} s")


def phase_trajectory(torch, ddpm_cfg) -> tuple[int, float]:
    """cli.generate --sav_denoise_path from the trained DDPM: the 999-step
    chain with CFG over the 27 labels, its latent grids and VQ decodes at 21
    steps. Returns the forward attention kernel's launches (the main path)
    and the chain's wall less the dumps."""
    from spectrogramgenai_tpu_torch.audio import export
    from spectrogramgenai_tpu_torch.cli import generate
    from spectrogramgenai_tpu_torch.data.manifest import class_names_from_folder
    from spectrogramgenai_tpu_torch.ops.attention import fused_attention
    from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask

    classes = class_names_from_folder("datasets/train")
    steps = ddpm_cfg.noise_steps - 1
    want_steps = generate.trajectory_steps(ddpm_cfg.noise_steps)
    # the dumps' share (host clock, each ending in a sync): the VQ decodes and the PNG writes
    dump_s = {"VQ decode": 0.0, "PNG writes": 0.0}
    decode, save = DiffusionTask.decode, export.save_generated_pngs

    def timed(key, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            dump_s[key] += time.perf_counter() - t
            return out
        return wrapper

    DiffusionTask.decode = timed("VQ decode", decode)
    export.save_generated_pngs = timed("PNG writes", save)
    fused_attention.launches = fused_attention.mma_launches = 0  # the main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        _, printed = run_quiet(generate.run, ddpm_cfg, "gen_traj_images", 1, 0, classes,
                               sav_denoise_path="trajectory", device="cuda")
        torch.cuda.synchronize()
    finally:
        DiffusionTask.decode, export.save_generated_pngs = decode, save
    wall = time.perf_counter() - t0
    launches, mma_launches = fused_attention.launches, fused_attention.mma_launches  # the main path ends here
    check("not saving images, just noise portions" in printed, "the reference's message")
    names = set(os.listdir("trajectory"))
    want = {f"{c}_noise_{i}_{kind}.png" for c in classes for i in want_steps for kind in ("latent", "decode")}
    check(len(want_steps) == 21 and names == want, f"{len(names)} trajectory PNGs, {len(want)} expected "
                                                   f"(21 steps × {len(classes)} classes × 2)")
    check(not os.listdir("gen_traj_images"), "no final images beside the trajectory")
    side = ddpm_cfg.img_size // ddpm_cfg.latent_downscale
    for c in (classes[0], classes[-1]):
        with open(f"trajectory/{c}_noise_1_latent.png", "rb") as f:
            check(png_rgb(f.read()).shape == (2 * side, 2 * side, 3), f"a latent grid of 2 × 2 channels of {side}²")
        with open(f"trajectory/{c}_noise_1_decode.png", "rb") as f:
            check(png_rgb(f.read()).shape == (ddpm_cfg.img_size, ddpm_cfg.img_size, 3), "a decode of the image size")
    check(launches == mma_launches >= 3 * steps, f"K1 launches {launches} on the tensor-core route "
                                                 f"({mma_launches}) >= 3 sites × {steps} steps")
    log(f"trajectory: cli.generate --sav_denoise_path, the {steps}-step DDPM chain with CFG at {len(classes)} labels "
        f"(UNet batch {2 * len(classes)}, {ddpm_cfg.compute_dtype}) and {len(names)} PNGs at {len(want_steps)} steps "
        f"in {wall:.2f} s wall ({1e3 * wall / steps:.2f} ms a step with the dumps); the dumps: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in dump_s.items())
        + f"; the chain alone {wall - sum(dump_s.values()):.2f} s "
        f"({1e3 * (wall - sum(dump_s.values())) / steps:.2f} ms a step); K1 launches {launches}, all on the "
        f"tensor-core route")
    return launches, wall - sum(dump_s.values())


def phase_profile_dir(torch, ddpm_cfg) -> None:
    """cli.train_ddpm --profile_dir for 2 steps of batch 32 (64 images of the
    corpus) with the trained run's model config and VQ-VAE: the Chrome trace
    loads and names both attention kernels."""
    from spectrogramgenai_tpu_torch.cli import train_ddpm
    from spectrogramgenai_tpu_torch.utils.profiling import TRACE_FILE

    linked = 0  # 2 batches of images, links into the corpus
    for c in sorted(os.listdir("datasets/train")):
        os.makedirs(f"datasets_prof/train/{c}")
        for name in sorted(os.listdir(f"datasets/train/{c}"))[:2 * TRAIN_BATCH - linked]:
            os.link(f"datasets/train/{c}/{name}", f"datasets_prof/train/{c}/{name}")
            linked += 1
        if linked == 2 * TRAIN_BATCH:
            break
    cfg = ddpm_cfg  # the trained run's model, on the 2 batches
    args = ["--profile_dir", "prof", "--data.dataset_path", "datasets_prof", "--data.batch_size", str(TRAIN_BATCH),
            "--data.img_size", str(cfg.data.img_size), "--img_size", str(cfg.img_size), "--num_classes",
            str(cfg.num_classes), "--width_mult", str(cfg.width_mult), "--remove_deep_conv", str(cfg.remove_deep_conv),
            "--vq_hidden_dim", str(cfg.vq_hidden_dim), "--vq_n_embeddings", str(cfg.vq_n_embeddings),
            "--compute_dtype", cfg.compute_dtype, "--vqae_ckpt", cfg.vqae_ckpt, "--epochs", "1",
            "--run.run_name", "smoke_prof", "--do_validation", "false"]
    t0 = time.perf_counter()
    state, printed = run_quiet(train_ddpm.main, args)
    wall = time.perf_counter() - t0
    path = os.path.join("prof", TRACE_FILE)
    size = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    fwd = sorted(k for k in kernels if "attention_fwd" in k)
    bwd = sorted(k for k in kernels if "attention_bwd" in k)
    check(state.step == 2, f"the profiled run trained {state.step} steps (2)")
    check(bool(fwd) and bool(bwd), f"the trace names attention_fwd ({fwd}) and attention_bwd ({bwd}) kernels")
    log(f"profile_dir: cli.train_ddpm --profile_dir, 2 steps of batch {TRAIN_BATCH} with the latent cache and a "
        f"preview, in {wall:.2f} s wall; {path}: {size / 2**20:.1f} MiB, {len(events)} events, {len(kernels)} kernel "
        f"names, among them {', '.join(fwd + bwd)}")


def phase_acgan_manifest(torch, batch_size: int = 16, extra: tuple = ()) -> None:
    """cli.train_acgan in manifest mode for one epoch at the ACGANConfig
    defaults with the acoustic indices: a specdata.npz of the corpus's train
    rows, a label CSV and an acoustic-index CSV, the images in one folder."""
    from spectrogramgenai_tpu_torch.audio.export import spec_png_name
    from spectrogramgenai_tpu_torch.cli import train_acgan
    from spectrogramgenai_tpu_torch.data.manifest import read_detection_manifest

    per_class = TRAIN_PER_CLASS + VAL_PER_CLASS
    rows = [r for i, r in enumerate(read_detection_manifest("manifest.csv")) if i % per_class < TRAIN_PER_CLASS]
    os.makedirs("manifest_images")
    for r in rows:
        name = spec_png_name(r["file_name"], r["begin_time"])
        os.link(f"datasets/train/{r['common_name']}/{name}", f"manifest_images/{name}")
    columns = ["file_name", "begin_time", "end_time", "common_name"]
    # times of three decimals, which the CSV reader parses back exactly: the merge matches on them
    table = [[i, r["file_name"], round(r["begin_time"], 3), round(r["end_time"], 3), r["common_name"]]
             for i, r in enumerate(rows)]
    np.savez("specdata.npz", train_df=np.asarray(table, dtype=object), test_df=np.asarray(table[:4], dtype=object),
             categories=np.asarray(sorted({r["common_name"] for r in rows})))
    with open("labels.csv", "w", newline="") as f:
        csv.writer(f).writerow(columns)
    rng = np.random.default_rng(8)
    with open("indices.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["file_path", "begin_time", "end_time", *train_acgan.INDEX_COLUMNS])
        for t in table:
            writer.writerow([t[1], t[2], t[3], *rng.normal(size=len(train_acgan.INDEX_COLUMNS)).round(6)])
    args = ["--manifest", "specdata.npz", "--lab_csv", "labels.csv", "--ai_csv", "indices.csv", "--im_path",
            "manifest_images", "--use_aind", "true", "--epochs", "2", "--num_classes", str(TRAIN_CLASSES),
            "--run.run_name", "smoke_acgan_manifest", "--data.batch_size", str(batch_size), *extra]
    steps = len(rows) // batch_size
    t0 = time.perf_counter()
    with counted_decode() as decode:
        (task, state), printed = run_quiet(train_acgan.main, args)
    wall = time.perf_counter() - t0
    for line in printed.splitlines():
        log(f"acgan_manifest: {line}")
    log_decode("acgan_manifest", decode)
    check(state.step == steps, f"manifest-mode ACGAN trained {state.step} steps ({steps})")
    check(task.discriminator.n_ind == len(train_acgan.INDEX_COLUMNS), "the discriminator has its acoustic-index head")
    with open("results/smoke_acgan_manifest/training_results.csv", newline="") as f:
        result = list(csv.DictReader(f))
    check([r["Epoch"] for r in result] == ["1"] and all(math.isfinite(float(v)) for v in result[0].values()),
          "one CSV row of finite losses")
    epoch = re.search(r"epoch 1: (\d+) steps in ([\d.]+) s, ([\d.]+) s/step, ([\d.]+) images/s", printed)
    check(epoch is not None, "the epoch line")
    log(f"acgan_manifest: {len(rows)} manifest rows merged with {len(table)} acoustic-index rows, z-normalised; "
        f"{steps} steps of batch {batch_size} with a_ind in {wall:.2f} s wall (with model build); epoch 1 "
        f"{epoch.group(3)} s/step, {epoch.group(4)} images/s")
    del task, state
    torch.cuda.empty_cache()


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

    t_smoke = t0 = time.perf_counter()
    _build.build(KERNEL_SOURCES + HOST_SOURCES)  # one nvcc (g++ for the host codecs) per source, started together
    log(f"build: {', '.join(KERNEL_SOURCES + HOST_SOURCES)} built and loaded in {time.perf_counter() - t0:.2f} s")
    for name in KERNEL_SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"build {name}: {line.strip()}")

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        return out

    kern = timed("kernel", phase_kernel, torch, attn)
    mel = timed("mel", phase_mel, torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        launches = timed("serve", phase_serve, torch, work)
        rank_launches = timed("serve_ranks", phase_serve_ranks, torch, work)
        export_launches, export_chain_s = timed("export", phase_export, torch, work)
        os.chdir(REPO)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_invert_") as work:
        timed("invert", phase_invert, torch, work)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_specs_") as work:
        mel_launches = timed("gen_specs", phase_gen_specs, torch, work)
    bwd = timed("attention_bwd", phase_attention_bwd, torch, attn)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        timed("datasets", make_train_datasets, work)
        vqae_ckpt = timed("train_vqvae", phase_train_vqvae, torch)
        train_launches, ddpm_cfg, train_s_per_step = timed("train", phase_train, torch, vqae_ckpt)
        par_launches = timed("parallel", phase_parallel, torch, ddpm_cfg, train_s_per_step)
        traj_launches, traj_chain_s = timed("trajectory", phase_trajectory, torch, ddpm_cfg)
        log(f"export: the 999-step chain from the ddpm artifact {export_chain_s:.2f} s (random weights, with its "
            f"decode) beside the eager chain of the trajectory phase {traj_chain_s:.2f} s (trained weights, "
            f"less its dumps)")
        timed("profile_dir", phase_profile_dir, torch, ddpm_cfg)
        sweep_args = timed("classifiers", phase_classifiers, torch, ddpm_cfg)
        timed("parallel_classifier", phase_parallel_classifier, torch, sweep_args)
        timed("figures", phase_figures, torch)
        timed("fid", phase_fid, torch)
        eval_launches, eval_audio = timed("evaluators", phase_evaluators, torch, work)
        provision_launches = timed("provision", phase_provision, torch, eval_audio)
        timed("acgan", phase_acgan, torch)
        timed("acgan_manifest", phase_acgan_manifest, torch)
        specunet_launches, denoiser_ckpt = timed("specunet", phase_specunet, torch, work)
        timed("denoised_classifiers", phase_denoised_classifiers, torch, denoiser_ckpt)
        os.chdir(REPO)

    kernels = [{"name": "attention_fwd", "route": "cuda",
                "source": "spectrogramgenai_tpu_torch/csrc/attention_fwd.cu",
                "replaces": "spectrogramgenai_tpu/ops/attention.py:83",
                "launches": launches + rank_launches + export_launches + train_launches[0] + traj_launches
                + par_launches["attention_fwd"], **kern},
               {"name": "attention_bwd", "route": "cuda",
                "source": "spectrogramgenai_tpu_torch/csrc/attention_bwd.cu",
                "replaces": "spectrogramgenai_tpu/ops/attention.py:150",
                "launches": train_launches[1] + par_launches["attention_bwd"], **bwd}]
    for _, rung, replaces in MEL_RUNGS:
        kernels.append({"name": f"mel_power_{rung}", "route": "cuda",
                        "source": "spectrogramgenai_tpu_torch/csrc/mel_power.cu", "replaces": replaces,
                        "launches": mel_launches[rung] + (specunet_launches + eval_launches + provision_launches
                                                        if rung == "exact" else 0),
                        **mel[rung]})
    log(f"smoke: {time.perf_counter() - t_smoke:.1f} s wall from the build to the kernels line")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
