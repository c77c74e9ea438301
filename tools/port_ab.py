#!/usr/bin/env python3
"""Compare chip_smoke.py phases between two checkouts of the PyTorch port on one card.

    python3 tools/port_ab.py --parent DIR [--phases attention_bwd,train] [--log_dir DIR]

Runs the phases of chip_smoke.py (``attention_bwd``: the backward kernels
against their plain version and their times; ``train``: cli.train_ddpm.run,
the step split and the profiler's device time) in a fresh process from the
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
SUMMARY = re.compile(r"^(train: (\d+ steps|one step)|attention_bwd(: three-site| sa_\d: bf16 kernel))")
RUN = """
import os, sys, tempfile
repo = sys.argv[1]
os.chdir(repo)
sys.path.insert(0, repo)
import torch
import chip_smoke as cs
import spectrogramgenai_tpu_torch.ops.attention as attn
from spectrogramgenai_tpu_torch.ops import _build
_build.build(cs.KERNEL_SOURCES)
for phase in sys.argv[2].split(","):
    if phase == "attention_bwd":
        cs.phase_attention_bwd(torch, attn)
    elif phase == "train":
        with tempfile.TemporaryDirectory(prefix="port_ab_") as work:
            cs.phase_train(torch, work)
            os.chdir(repo)
    else:
        raise SystemExit(f"unknown phase {phase}")
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="checkout of the parent commit (git archive)")
    ap.add_argument("--phases", default="attention_bwd,train")
    ap.add_argument("--log_dir", default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = [("parent", args.parent), ("change", HERE), ("change", HERE), ("parent", args.parent)]
    for i, (who, repo) in enumerate(turns):
        run = subprocess.run([sys.executable, "-c", RUN, os.path.abspath(repo), args.phases],
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
