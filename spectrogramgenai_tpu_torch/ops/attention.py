"""Fused self-attention: softmax(q·kᵀ/√d)·v over (B, H, N, D), and its VJP.

Counterpart of ``spectrogramgenai_tpu/ops/attention.py``. :func:`fused_attention`
is differentiable through a ``torch.autograd.Function`` that saves q, k and v
(the JAX custom VJP's residuals) and, for bf16 inputs, the forward's row
log-sum-exp and f32 output, and recomputes P in the backward:

  * forward: on a CUDA tensor the kernel of ``csrc/attention_fwd.cu``, on a
    CPU tensor :func:`attention_reference`;
  * backward (:func:`fused_attention_bwd`): on a CUDA tensor the kernels of
    ``csrc/attention_bwd.cu`` (tensor-core kernels for bf16, which take the
    residuals; scalar ones for float32), on a CPU tensor
    :func:`attention_bwd_reference`.

Each plain version computes the same function in PyTorch; a CUDA tensor
launches the kernel or raises. There is no other path. Under
``torch.inference_mode`` or ``no_grad`` (serving) no autograd node is made.
"""

from __future__ import annotations

import ctypes
import math

import torch

from spectrogramgenai_tpu_torch.ops import _build

SUPPORTED_HEAD_DIMS = (2, 4, 8, 16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_Q = 128  # query rows per kernel block: N must be a multiple
LOG2E = 1.4426950408889634


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, residuals: bool = False):
    """Plain version: the full (N, N) score matrix in float32. With
    ``residuals``, also the kernel's residuals: the row log-sum-exp of the
    scores in the exp2 domain, log2 Σ_j 2^(s_j·log2 e), as (B, H, N) float32,
    and the output before its cast, (B, H, N, D) float32."""
    d = q.shape[-1]
    s = (q.float() @ k.float().mT) / math.sqrt(d)
    o32 = torch.softmax(s, dim=-1) @ v.float()
    if residuals:
        return o32.to(q.dtype), torch.logsumexp(s, dim=-1) * LOG2E, o32
    return o32.to(q.dtype)


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the VJP, with the full (N, N) matrices in float32:
    P = softmax(q·kᵀ/√d); dV = Pᵀ·dO; dP = dO·Vᵀ; dS = P∘(dP − rowsum(dP∘P));
    dQ = dS·K/√d; dK = dSᵀ·Q/√d. Outputs in the input dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.softmax((qf @ kf.mT) * scale, dim=-1)
    dv = p.mT @ dof
    ds = dof @ vf.mT  # dP, turned into dS in place to keep one (N, N) temporary
    c = (ds * p).sum(dim=-1, keepdim=True)
    ds.sub_(c).mul_(p)
    del p
    dq = (ds @ kf) * scale
    dk = (ds.mT @ qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel(name: str, n_pointers: int) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:  # first use: declare the C signatures
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")


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


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, residuals: bool = False):
    if q.device.type == "cpu":
        return attention_reference(q, k, v, residuals)
    b, h, n, d = q.shape
    lib = _kernel("attention_fwd", 6)
    out = torch.empty_like(q)
    lse = o32 = None
    if residuals:
        lse = torch.empty(b, h, n, dtype=torch.float32, device=q.device)
        o32 = torch.empty(b, h, n, d, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                lse.data_ptr() if residuals else None, o32.data_ptr() if residuals else None,
                                b * h, n, d, _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "attention_fwd", err)
    fused_attention.launches += 1
    return (out, lse, o32) if residuals else out


def fused_attention_residuals(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(out, lse, o32): the forward with the residuals that the bf16 backward
    takes — the row log-sum-exp in the exp2 domain, (B, H, N) float32, and
    the output in float32. Counts in ``fused_attention.launches``."""
    _check(q, k, v)
    return _forward(q, k, v, residuals=True)


def _check_residual(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.shape != shape or t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor of shape {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor | None = None,
                        o32: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax(q·kᵀ/√d)·v for the output gradient ``do``, each
    in the input dtype. bf16 inputs on the card take the forward's residuals
    (``fused_attention_residuals``) and raise without them; float32 inputs and
    CPU tensors do not need them. ``fused_attention_bwd.launches`` counts the
    calls that launch the kernels (two per call: dQ, then dK and dV)."""
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device or not do.is_contiguous():
        raise ValueError(f"do must be a contiguous {q.dtype} tensor of shape {tuple(q.shape)} on "
                         f"{q.device}, got {do.dtype} {tuple(do.shape)} on {do.device}")
    if (lse is None) != (o32 is None):
        raise ValueError("lse and o32 are given together or not at all")
    if lse is not None:
        _check_residual("lse", lse, q.shape[:3], q.device)
        _check_residual("o32", o32, q.shape, q.device)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, do)
    bf16 = q.dtype == torch.bfloat16
    if bf16 and lse is None:
        raise ValueError("the bf16 backward kernels take the forward's residuals lse and o32 "
                         "(fused_attention_residuals)")
    b, h, n, d = q.shape
    lib = _kernel("attention_bwd", 10)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty((1 if bf16 else 3) * b * h * n, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                lse.data_ptr() if bf16 else None, o32.data_ptr() if bf16 else None,
                                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
                                b * h, n, d, _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "attention_bwd", err)
    fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_bwd.launches = 0


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        if q.dtype == torch.bfloat16:  # the bf16 backward reads P and c from these
            out, lse, o32 = _forward(q, k, v, residuals=True)
            ctx.save_for_backward(q, k, v, lse, o32)
            return out
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        return fused_attention_bwd(*ctx.saved_tensors[:3], do.contiguous(), *ctx.saved_tensors[3:])


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v, non-causal and unmasked, f32 accumulation, output
    in the input dtype; differentiable. Inputs are validated before the device
    is looked at. ``fused_attention.launches`` counts forward kernel launches."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FusedAttention.apply(q, k, v)
    return _forward(q, k, v)


fused_attention.launches = 0
