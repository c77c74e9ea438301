#!/usr/bin/env python3
"""Per-row error of the rounding plans of the bf16 attention kernels, on the CPU.

    python3 tools/port_bwd_rounding.py [--heads 4] [--threads 4]

The tensor-core kernels of spectrogramgenai_tpu_torch/csrc/ take their
products with bf16 operands and f32 sums. Their plain emulations, the
forward's serving (one bf16 P) and residual (P as bf16 hi + lo) plans and
the backward's plans (P and dS as one bf16 or hi + lo), are in
tests/torch_attention_helpers.py, which the CPU tests use too.

The script runs both at the UNet's training sites (N, d) = (1024, 32),
(1024, 16), (4096, 16), on random bf16 inputs and on a large-logit head (a
key component of 200), and prints each backward plan's largest per-row error
of dQ, dK and dV against float64, given the forward's residuals as the
tensor-core forward writes them (hi + lo P), as the one-bf16 plan would
write them, and in float64, beside the bf16 rounding of the float64 result
itself. Imports torch only.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))
from torch_attention_helpers import (  # noqa: E402
    backward,
    exact64,
    exact_residuals,
    forward,
    one_bf16_residuals,
    row_rel_err,
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    gen = torch.Generator().manual_seed(3)
    for n, d in ((1024, 32), (1024, 16), (4096, 16)):
        q, k, v, do = (torch.randn(1, args.heads, n, d, generator=gen) for _ in range(4))
        k_large = k.clone()
        k_large[..., 0] += 200.0
        for label, kk in (("random", k), ("large logits", k_large)):
            args_bf = [t.bfloat16() for t in (q, kk, v, do)]
            want = exact64(*args_bf)
            floor = [row_rel_err(w.bfloat16(), w) for w in want]
            print(f"N {n} d {d} {label}: per-row error against float64 (dq, dk, dv); "
                  f"output rounding {' '.join(f'{e:.3g}' for e in floor)}", flush=True)
            residuals = (("forward hi + lo", forward(*args_bf[:3], residuals=True)[1:]),
                         ("forward one bf16", one_bf16_residuals(*args_bf[:3])),
                         ("float64", exact_residuals(*args_bf[:3])))
            for res_name, (lse, o32) in residuals:
                line = [f"  residuals {res_name}"]
                for name, pairs in (("one bf16", False), ("hi + lo", True)):
                    errs = [row_rel_err(g, w) for g, w in zip(backward(*args_bf, lse, o32, pairs=pairs), want)]
                    line.append(f"{name} {' '.join(f'{e:.3g}' for e in errs)}")
                print("; ".join(line), flush=True)


if __name__ == "__main__":
    main()
