"""Plain emulations of the rounding plans of the bf16 attention kernels
(``csrc/attention_fwd.cu`` attention_fwd_mma, ``csrc/attention_bwd.cu``), for
the CPU tests and tools/port_bwd_rounding.py. Imports torch only.

The kernels take their products with bf16 operands and f32 sums.
``forward`` emulates the forward: the online softmax over 64-key tiles, P
entering P·V as one bf16 (serving, the JAX kernel's plan, with the
denominator summed from those bf16 values) or as a bf16 hi + lo pair with
the denominator and lse from the f32 P (the residuals that training saves).
``backward`` emulates the backward given the residuals lse and O₃₂, with P
and dS rounded to one bf16 each, or split into hi + lo pairs (what the
kernels do).
"""

from __future__ import annotations

import math

import torch

LOG2E = 1.4426950408889634
KEY_TILE = 64  # keys per tile of the forward kernel's online softmax


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def scale_log2(d: int) -> torch.Tensor:
    """log2(e)/√d as the kernels form it in f32: log2(e) · (1/√d)."""
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(d), dtype=torch.float32).sqrt()
    return torch.tensor(LOG2E, dtype=torch.float32) * inv


def forward(q, k, v, residuals: bool):
    """The tensor-core forward's arithmetic on bf16 inputs (products exact in
    f32), 64 keys at a time. Serving (``residuals`` False): the score's
    exponent as one rounding of dot·c − shift (the kernel's FMA), P as one
    bf16 in P·V and in the denominator; returns the output in the input
    type. Residuals: the score s = dot·c rounded on its own, P as bf16 hi + lo
    in P·V, the denominator from the f32 P; returns (out, lse, o32)."""
    c = scale_log2(q.shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    shape = q.shape[:-1]
    m = shift = torch.full(shape, -math.inf)
    acc, den = torch.zeros(q.shape), torch.zeros(shape)
    for t0 in range(0, k.shape[-2], KEY_TILE):
        dot = qf @ kf[..., t0:t0 + KEY_TILE, :].mT
        s = dot * c if residuals else dot
        m = torch.maximum(m, s.amax(-1))
        nxt = m if residuals else m * c
        alpha = torch.exp2(shift - nxt)
        shift = nxt
        if residuals:
            p = torch.exp2(s - shift[..., None])
        else:
            p = torch.exp2((dot.double() * c.double() - shift[..., None].double()).float())
        hi = _bf16(p)
        vt = vf[..., t0:t0 + KEY_TILE, :]
        if residuals:
            pv, psum = hi @ vt + _bf16(p - hi) @ vt, p.sum(-1)
        else:
            pv, psum = hi @ vt, hi.sum(-1)
        acc = acc * alpha[..., None] + pv
        den = den * alpha + psum
    o32 = acc / den[..., None]
    if residuals:
        return o32.to(q.dtype), shift + torch.log2(den), o32
    return o32.to(q.dtype)


def backward(q, k, v, do, lse, o32, pairs: bool):
    """(dq, dk, dv) in bf16 from bf16 inputs and the forward's residuals: f32
    sums of exact products, P = exp2(s − lse), c = rowsum(dO∘O₃₂); P and dS
    rounded to one bf16, or to hi + lo with ``pairs``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = (qf @ kf.mT) * scale_log2(q.shape[-1])
    p = torch.exp2(s - lse[..., None])
    ds = p * (dof @ vf.mT - (dof * o32).sum(-1, keepdim=True))

    def parts(x):
        hi = _bf16(x)
        return (hi, _bf16(x - hi)) if pairs else (hi,)

    dv = sum(t.mT @ dof for t in parts(p))
    dq = sum(t @ kf for t in parts(ds)) * scale
    dk = sum(t.mT @ qf for t in parts(ds)) * scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def exact_residuals(q, k, v):
    """(lse, o32) from float64, rounded once to f32."""
    q, k, v = (t.double() for t in (q, k, v))
    s = q @ k.mT / math.sqrt(q.shape[-1])
    return (torch.logsumexp(s, -1) * LOG2E).float(), (torch.softmax(s, -1) @ v).float()


def one_bf16_residuals(q, k, v):
    """(lse, o32) as the forward would write them with one bf16 P in P·V."""
    c = scale_log2(q.shape[-1])
    s = (q.float() @ k.float().mT) * c
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    return (m[..., 0] + torch.log2(p.sum(-1))), (_bf16(p) @ v.float()) / p.sum(-1, keepdim=True)


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
