#!/usr/bin/env python3
"""Compare chip_smoke.py phases between two checkouts of the PyTorch port on one card.

    python3 tools/port_ab.py --parent DIR [--phases kernel,mel,serve,attention_bwd,train,mel_shapes] [--log_dir DIR]

Runs the phases of chip_smoke.py (``kernel``: the attention forward at the
three UNet sites against its plain version, and its times; ``mel``: the three
mel rungs at batch 64; ``serve``: cli.serve.run at full width, images/s and a
served batch's device time; ``attention_bwd``: the backward kernels against
their plain version and their times; ``train``: cli.train_ddpm.run, the step
split and the profiler's device time; ``mel_shapes``: the high and fast
mel kernels at the card tests' other shapes, n_fft 64 to 4096, each held
against its plain version and against the same rounding plan summed in
float64) in a fresh process from the
checkout at ``--parent`` and from this one, in turns — parent, change,
change, parent — so that a drift of the card or its host over the call shows
as a spread and not as a difference. Each checkout builds its own kernels
from its own sources. The phases' summary lines are printed under a header
naming the turn; with ``--log_dir`` each run's whole output is kept there.
Exits non-zero if a run fails. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUMMARY = re.compile(r"^(train: (\d+ steps|one step)|attention_bwd(: three-site| sa_\d: bf16 kernel)"
                     r"|kernel( sa_\d|: head dims)|mel (exact|high|fast): batch|mel: torch\.stft"
                     r"|serve: (\d+ images|UNet forward|one batch)|mel_shapes )")
RUN = """
import os, sys, tempfile
repo = sys.argv[1]
os.chdir(repo)
sys.path.insert(0, repo)
sys.path.append(sys.argv[3])  # this checkout's tests/, for the stress clips and the error measure
import torch


def mel_shapes(torch):
    import numpy as np
    from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig, constants, frame_signal
    from spectrogramgenai_tpu_torch.ops import mel_kernel as mk
    from torch_mel_helpers import mel_rel_err, stress_audio

    torch.backends.cuda.matmul.allow_tf32 = False

    def split64(x):  # float32 → its bf16 hi and lo parts, as float64
        hi = x.bfloat16()
        return hi.double(), (x - hi.float()).bfloat16().double()

    def plan64(audio, cfg, rung):  # the rung's operands and products, every sum in float64
        frames = frame_signal(audio, cfg)
        wc, ws = (torch.from_numpy(w).cuda() for w in mk._dft(cfg))
        fb_t = torch.from_numpy(np.ascontiguousarray(constants(cfg)[1].T)).cuda()

        def prod(a, b):
            if rung == "fast":
                return a.bfloat16().double() @ b.bfloat16().double()
            (ah, al), (bh, bl) = split64(a), split64(b)
            return ah @ bh + ah @ bl + al @ bh

        re, im = prod(frames, wc), prod(frames, ws)
        return prod((re * re + im * im).float(), fb_t)

    for n_fft, hop, n_mels in ((64, 16, 16), (64, 48, 20), (2048, 512, 256), (2048, 1024, 256),
                               (4096, 384, 256)):
        cfg = SpectrogramConfig(n_fft=n_fft, hop_length=hop, n_mels=n_mels)
        audio = torch.from_numpy(np.ascontiguousarray(stress_audio(cfg, 6)[:, :100_001])).cuda()
        for rung, exact in (("high", "high"), ("fast", False)):
            try:
                got = mk.fused_mel_power(audio, cfg, exact)
            except (RuntimeError, ValueError) as e:  # a shape that this checkout's kernel does not take
                print(f"mel_shapes n_fft {n_fft} hop {hop} n_mels {n_mels} {rung}: not taken ({e})", flush=True)
                continue
            want = mk.mel_power_reference(audio, cfg, exact)
            exact64 = plan64(audio, cfg, rung)
            print(f"mel_shapes n_fft {n_fft} hop {hop} n_mels {n_mels} {rung}: kernel vs plain "
                  f"{mel_rel_err(got, want):.4g}; against the plan in float64: kernel "
                  f"{mel_rel_err(got.double(), exact64):.4g}, plain {mel_rel_err(want.double(), exact64):.4g}",
                  flush=True)
            del got, want, exact64
        torch.cuda.empty_cache()

import chip_smoke as cs
import spectrogramgenai_tpu_torch.ops.attention as attn
from spectrogramgenai_tpu_torch.ops import _build
_build.build(cs.KERNEL_SOURCES)
# the smoke runs every phase after its kernel phase, which leaves TF32 off (the serve
# phase's float32 route check needs that)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
for phase in sys.argv[2].split(","):
    if phase == "kernel":
        cs.phase_kernel(torch, attn)
    elif phase == "mel":
        cs.phase_mel(torch)
    elif phase == "serve":
        with tempfile.TemporaryDirectory(prefix="port_ab_") as work:
            cs.phase_serve(torch, work)
            os.chdir(repo)
    elif phase == "attention_bwd":
        cs.phase_attention_bwd(torch, attn)
    elif phase == "train":
        with tempfile.TemporaryDirectory(prefix="port_ab_") as work:
            if hasattr(cs, "phase_train_vqvae"):  # the DDPM starts from a VQ-VAE that the checkout trains
                cs.make_train_datasets(work)
                cs.phase_train(torch, cs.phase_train_vqvae(torch))
            else:
                cs.phase_train(torch, work)
            os.chdir(repo)
    elif phase == "mel_shapes":
        mel_shapes(torch)
    else:
        raise SystemExit(f"unknown phase {phase}")
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="checkout of the parent commit (git archive)")
    ap.add_argument("--phases", default="kernel,mel,serve,attention_bwd,train")  # or add mel_shapes
    ap.add_argument("--log_dir", default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = [("parent", args.parent), ("change", HERE), ("change", HERE), ("parent", args.parent)]
    for i, (who, repo) in enumerate(turns):
        run = subprocess.run([sys.executable, "-c", RUN, os.path.abspath(repo), args.phases,
                              os.path.join(HERE, "tests")],
                             capture_output=True, text=True)
        out = run.stdout + run.stderr
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
            with open(os.path.join(args.log_dir, f"ab_{i}_{who}.log"), "w") as f:
                f.write(out)
        print(f"== turn {i + 1}: {who} ({repo})", flush=True)
        for line in out.splitlines():
            if SUMMARY.match(line):
                print(line[:400], flush=True)
        if run.returncode != 0:
            print("\n".join(out.splitlines()[-20:]), flush=True)
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
