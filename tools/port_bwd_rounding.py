#!/usr/bin/env python3
"""Per-row error of two rounding plans for the bf16 attention backward, on the CPU.

    python3 tools/port_bwd_rounding.py [--heads 4] [--threads 4]

The tensor-core backward (spectrogramgenai_tpu_torch/csrc/attention_bwd.cu)
multiplies P and dS, which it forms in f32, with bf16 operands. This script
emulates its arithmetic in plain PyTorch at the UNet's training sites (N,
d) = (1024, 32), (1024, 16), (4096, 16), on random bf16 inputs and on a
large-logit head (a key component of 200), with P and dS rounded to one bf16
each, or split into bf16 hi + lo pairs (what the kernels do), and prints
each plan's largest per-row error of dQ, dK and dV against float64, beside
the bf16 rounding of the float64 result itself. Imports torch and numpy only.
"""

from __future__ import annotations

import argparse
import math

import torch

LOG2E = 1.4426950408889634


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def backward(q, k, v, do, pairs: bool):
    """(dq, dk, dv) in bf16 from bf16 inputs: f32 sums of exact products, P
    from the row log-sum-exp, c = rowsum(dO∘O); P and dS rounded to one bf16,
    or to hi + lo with ``pairs``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = (qf @ kf.mT) * torch.tensor(LOG2E * scale, dtype=torch.float32)
    lse = (torch.logsumexp(s.double() / LOG2E, -1, keepdim=True) * LOG2E).float()
    p = torch.exp2(s - lse)
    ds = p * (dof @ vf.mT - (dof * (p @ vf)).sum(-1, keepdim=True))

    def parts(x):
        hi = _bf16(x)
        return (hi, _bf16(x - hi)) if pairs else (hi,)

    dv = sum(t.mT @ dof for t in parts(p))
    dq = sum(t @ kf for t in parts(ds)) * scale
    dk = sum(t.mT @ qf for t in parts(ds)) * scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def exact64(q, k, v, do):
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(q @ k.mT * scale, dim=-1)
    dp = do @ v.mT
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return ds @ k * scale, ds.mT @ q * scale, p.mT @ do


def row_rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


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
            line = [f"N {n} d {d} {label}: per-row error against float64 (dq, dk, dv)"]
            for name, pairs in (("one bf16", False), ("hi + lo", True)):
                errs = [row_rel_err(g, w) for g, w in zip(backward(*args_bf, pairs=pairs), want)]
                line.append(f"{name} {' '.join(f'{e:.3g}' for e in errs)}")
            line.append(f"output rounding {' '.join(f'{e:.3g}' for e in floor)}")
            print("; ".join(line), flush=True)


if __name__ == "__main__":
    main()
