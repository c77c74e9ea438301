"""Operations and bytes of the fused attention's forward (K1) and backward
(K1b) for one call on (B, H, N, D) bf16 tensors, and their least time on a
chip: the larger of operations over the bf16 tensor-core peak and bytes
over the memory bandwidth. Each input byte is counted read once and each
output byte written once."""

from __future__ import annotations


def fwd(b: int, h: int, n: int, d: int) -> tuple[float, float]:
    """(FLOPs, bytes): S = QKᵀ and O = PV, 2·N²·D each; q, k, v read, o written."""
    return 4.0 * b * h * n * n * d, 2.0 * 4 * b * h * n * d


def bwd(b: int, h: int, n: int, d: int) -> tuple[float, float]:
    """(FLOPs, bytes): S = QKᵀ again, dP = dO·Vᵀ, dV = Pᵀ·dO, dQ = dS·K, dK =
    dSᵀ·Q, 2·N²·D each; q, k, v, dO read (bf16), the row log-sum-exp (f32) and
    the f32 output read, dq, dk, dv written (bf16)."""
    return 10.0 * b * h * n * n * d, b * h * n * (2.0 * 7 * d + 4.0 + 4.0 * d)


def least_seconds(flops: float, nbytes: float, peaks: dict) -> float:
    return max(flops / peaks["bf16_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
