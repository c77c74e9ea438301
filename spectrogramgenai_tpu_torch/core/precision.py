"""Full float32 arithmetic on the card for the span of a ``with`` block."""

from __future__ import annotations

import contextlib
import threading

import torch

_LOCK = threading.RLock()


@contextlib.contextmanager
def full_float32():
    """cuBLAS products and cuDNN convolutions in full float32 (TF32 off)
    inside the block, the previous settings restored after it. The H100's
    cuDNN uses TF32 for float32 convolutions by default, which leaves ~1e-3
    of relative error where the JAX package (and the CPU) computes float32."""
    with _LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
