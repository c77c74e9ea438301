"""Bulk wav → 256×256 log-mel spectrogram export.

Reads a manifest of (file_name, begin_time, end_time, common_name) rows (a
CSV, or the ``train_df`` split of a ``specdata.npz``), decodes the
reference's 6-s windows with the native batch WAV decoder
(``data/native_wav.py``, bit-equal to ``audio/wavio.load_wav`` +
``slice_clip``), computes log-mel spectrograms in batches of one sample rate
through the fused mel kernel (``ops/mel_kernel.py``, hand-written CUDA), and
writes viridis PNGs named ``{file}_{begin}_{begin}.png`` through the native
PNG encoder (plus the exact float32 arrays as .npy with --save_npy 1). A
missing or unreadable WAV is skipped. Runs on CUDA unless --device cpu is
asked for, which computes the kernels' plain PyTorch version instead.

  python -m spectrogramgenai_tpu_torch.cli.gen_specs --manifest specdata.csv \\
      --wav_dir Birdnet_conf_files --out_dir images [--skip_existing 1] [--exact 1|high|0]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

EXACT_CHOICES = {"0": False, "1": True, "high": "high"}
DECODE_THREADS = 8  # the native WAV decoder's threads (the JAX CLI's)


def run(manifest: str, wav_dir: str, out_dir: str, batch_size: int = 64, skip_existing: bool = True,
        save_npy: bool = False, limit: int | None = None, exact=True, device: str = "cuda") -> int:
    """Write one spectrogram per manifest row whose wav exists; returns how many were written."""
    from spectrogramgenai_tpu_torch.audio.export import (
        save_spectrogram_npy,
        save_spectrogram_pngs,
        spec_png_name,
    )
    from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig
    from spectrogramgenai_tpu_torch.cli.common import DeviceTimer, resolve_device
    from spectrogramgenai_tpu_torch.data.manifest import read_detection_manifest
    from spectrogramgenai_tpu_torch.data.native_wav import load_wav_batch
    from spectrogramgenai_tpu_torch.ops.mel_kernel import fused_mel_power, logmel_from_power, rung_name

    rung_name(exact)  # reject a bad value before any work
    dev = resolve_device(device)
    rows = read_detection_manifest(manifest, limit)
    os.makedirs(out_dir, exist_ok=True)

    pending: dict[int, list] = {}  # sample rate → [(row, clip)], so that each batch has one rate
    n_done = n_batches = 0
    decode_s = encode_s = 0.0
    kernel_timer, glue_timer = DeviceTimer(dev), DeviceTimer(dev)
    t0 = time.time()

    def flush(sr: int):
        nonlocal n_done, n_batches, encode_s
        batch = pending.pop(sr, [])
        if not batch:
            return
        cfg = SpectrogramConfig(sample_rate=sr)
        clips = torch.from_numpy(np.stack([c for _, c in batch])).to(dev)
        mel = kernel_timer(lambda: fused_mel_power(clips, cfg, exact=exact))
        specs = glue_timer(lambda: logmel_from_power(mel, cfg)).cpu().numpy()
        t_enc = time.perf_counter()
        names = [spec_png_name(row["file_name"], row["begin_time"]) for row, _ in batch]
        save_spectrogram_pngs(specs, [os.path.join(out_dir, n) for n in names])
        if save_npy:
            for name, spec in zip(names, specs):
                save_spectrogram_npy(spec, os.path.join(out_dir, name.replace(".png", ".npy")))
        encode_s += time.perf_counter() - t_enc
        n_done += len(batch)
        n_batches += 1

    todo = []
    for row in rows:
        if skip_existing and os.path.exists(os.path.join(out_dir, spec_png_name(row["file_name"], row["begin_time"]))):
            continue  # birdnet_all_spec.py:41-42 semantics
        wav_path = os.path.join(wav_dir, row["file_name"])
        if os.path.exists(wav_path):
            todo.append((row, wav_path))

    chunk = 4 * batch_size  # rows a native call decodes
    for start in range(0, len(todo), chunk):
        part = todo[start:start + chunk]
        t_dec = time.perf_counter()
        clips, rates = load_wav_batch([p for _, p in part], [r["begin_time"] for r, _ in part],
                                      [r["end_time"] for r, _ in part], 6.0, num_threads=DECODE_THREADS)
        decode_s += time.perf_counter() - t_dec
        for (row, _), clip, sr in zip(part, clips, rates.tolist()):
            if sr <= 0:
                continue  # unreadable: skipped, as the JAX CLI does
            # a copy: a view would keep the whole chunk's buffer alive until its rate's batch is full
            pending.setdefault(sr, []).append((row, clip[:int(6.0 * sr)].copy()))
            if len(pending[sr]) >= batch_size:
                flush(sr)
    for sr in list(pending):
        flush(sr)

    dt = time.time() - t0
    clock = "CUDA events" if dev.type == "cuda" else "host"
    print(f"gen_specs: decode {decode_s:.3f} s, mel kernel {kernel_timer.seconds():.3f} s, "
          f"dB glue {glue_timer.seconds():.3f} s ({clock}, {n_batches} batches), encode {encode_s:.3f} s")
    print(f"wrote {n_done} spectrograms to {out_dir} in {dt:.1f}s ({n_done / max(dt, 1e-9):.1f} specs/sec)")
    return n_done


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--manifest", required=True)
    p.add_argument("--wav_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--skip_existing", type=int, default=1)
    p.add_argument("--save_npy", type=int, default=0)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--exact", default="1", choices=list(EXACT_CHOICES),
                   help="1 = a float64 FFT, the oracle's arithmetic (default); high = three bf16 tensor-core "
                        "products (bf16_3x); 0 = one bf16 product of bf16-rounded operands, fastest")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    a = p.parse_args(argv)
    run(a.manifest, a.wav_dir, a.out_dir, a.batch_size, bool(a.skip_existing), bool(a.save_npy), a.limit,
        exact=EXACT_CHOICES[a.exact], device=a.device)


if __name__ == "__main__":
    main()
