"""Fused self-attention forward: softmax(q·kᵀ/√d)·v over (B, H, N, D).

Counterpart of ``spectrogramgenai_tpu/ops/attention.py`` (forward only; the
backward comes with training). On a CUDA tensor :func:`fused_attention`
launches the hand-written kernel in ``csrc/attention_fwd.cu`` or raises; on a
CPU tensor it computes :func:`attention_reference`, the plain PyTorch
version of the same function. There is no other path.
"""

from __future__ import annotations

import ctypes
import math

import torch

from spectrogramgenai_tpu_torch.ops import _build

SUPPORTED_HEAD_DIMS = (2, 4, 8, 16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_Q = 128  # query rows per kernel block: N must be a multiple


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: the full (N, N) score matrix in float32."""
    d = q.shape[-1]
    out = torch.softmax((q.float() @ k.float().mT) / math.sqrt(d), dim=-1) @ v.float()
    return out.to(q.dtype)


def _kernel() -> ctypes.CDLL:
    lib = _build.load("attention_fwd")
    if lib.attention_fwd.argtypes is None:  # first use: declare the C signatures
        p = ctypes.c_void_p
        lib.attention_fwd.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, p]
        lib.attention_fwd.restype = ctypes.c_int
        lib.attention_fwd_error_string.argtypes = [ctypes.c_int]
        lib.attention_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, N, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k, v must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    n, d = q.shape[2], q.shape[3]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (one of {SUPPORTED_HEAD_DIMS})")
    if n % BLOCK_Q:
        raise ValueError(f"sequence length {n} not a multiple of {BLOCK_Q}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v, non-causal and unmasked, f32 accumulation, output
    in the input dtype. Inputs are validated before the device is looked at.
    ``fused_attention.launches`` counts kernel launches."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    b, h, n, d = q.shape
    lib = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                b * h, n, d, _DTYPE_CODES[q.dtype],
                                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.attention_fwd_error_string(err).decode()
        raise RuntimeError(f"attention_fwd launch failed: {msg} (cudaError {err})")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
