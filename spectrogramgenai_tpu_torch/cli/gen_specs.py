"""Bulk wav → 256×256 log-mel spectrogram export.

Reads a manifest CSV of (file_name, begin_time, end_time, common_name) rows,
slices the reference's 6-s windows, computes log-mel spectrograms in batches
through the fused mel kernel (``ops/mel_kernel.py``, hand-written CUDA), and
writes viridis PNGs named ``{file}_{begin}_{begin}.png`` (plus the exact
float32 arrays as .npy with --save_npy 1). Runs on CUDA unless --device cpu
is asked for, which computes the kernels' plain PyTorch version instead.

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


class _DeviceTimer:
    """Summed time of the calls it wraps: CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pending: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.cpu_seconds = 0.0

    def __call__(self, fn):
        if self.cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            self.pending.append((start, end))
            return out
        t0 = time.perf_counter()
        out = fn()
        self.cpu_seconds += time.perf_counter() - t0
        return out

    def seconds(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
            return sum(s.elapsed_time(e) for s, e in self.pending) / 1e3
        return self.cpu_seconds


def run(manifest: str, wav_dir: str, out_dir: str, batch_size: int = 64, skip_existing: bool = True,
        save_npy: bool = False, limit: int | None = None, exact=True, device: str = "cuda") -> int:
    """Write one spectrogram per manifest row whose wav exists; returns how many were written."""
    from spectrogramgenai_tpu_torch.audio.export import (
        save_spectrogram_npy,
        save_spectrogram_pngs,
        spec_png_name,
    )
    from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig
    from spectrogramgenai_tpu_torch.audio.wavio import load_wav, slice_clip
    from spectrogramgenai_tpu_torch.cli.common import resolve_device
    from spectrogramgenai_tpu_torch.data.manifest import read_detection_manifest
    from spectrogramgenai_tpu_torch.ops.mel_kernel import fused_mel_power, logmel_from_power, rung_name

    rung_name(exact)  # reject a bad value before any work
    dev = resolve_device(device)
    rows = read_detection_manifest(manifest, limit)
    os.makedirs(out_dir, exist_ok=True)

    pending: dict[int, list] = {}  # sample rate → [(row, clip)], so that each batch has one rate
    n_done = n_batches = 0
    decode_s = encode_s = 0.0
    kernel_timer, glue_timer = _DeviceTimer(dev), _DeviceTimer(dev)
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

    cached_path, cached = None, None  # consecutive rows often share a recording
    for row in rows:
        name = spec_png_name(row["file_name"], row["begin_time"])
        if skip_existing and os.path.exists(os.path.join(out_dir, name)):
            continue  # birdnet_all_spec.py:41-42 semantics
        wav_path = os.path.join(wav_dir, row["file_name"])
        if not os.path.exists(wav_path):
            continue
        t_dec = time.perf_counter()
        if wav_path != cached_path:
            try:
                cached_path, cached = wav_path, load_wav(wav_path)
            except (OSError, ValueError):  # unreadable file: skipped, as the JAX CLI's decoder does
                cached_path, cached = wav_path, None
        if cached is not None:
            wav, sr = cached
            pending.setdefault(sr, []).append((row, slice_clip(wav, sr, row["begin_time"], row["end_time"])))
        decode_s += time.perf_counter() - t_dec
        if cached is not None and len(pending[sr]) >= batch_size:
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
