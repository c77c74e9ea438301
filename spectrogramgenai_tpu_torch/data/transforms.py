"""On-device batch transforms (torch, NHWC), after ``spectrogramgenai_tpu/data/transforms.py``
(its bilinear resize is not ported)."""

from __future__ import annotations

import torch


def renorm_m1_1(x: torch.Tensor) -> torch.Tensor:
    """Per-sample min/max rescale to [-1, 1], reducing over every non-batch dim,
    with the JAX module's sign trick on the (never negative) range."""
    dims = tuple(range(1, x.dim()))
    mn = x.amin(dim=dims, keepdim=True)
    mx = x.amax(dim=dims, keepdim=True)
    m = mx - mn
    y = (x - mn) / m
    sign = torch.where(m >= 0, 1.0, -1.0).to(x.dtype)
    return sign * 2.0 * (y - 0.5)


def expand_channels(x: torch.Tensor, n_channels: int) -> torch.Tensor:
    """(B, H, W, 1) → (B, H, W, n) by repetition; n channels → 1 by their mean."""
    if x.shape[-1] == n_channels:
        return x
    if x.shape[-1] == 1:
        return x.expand(*x.shape[:-1], n_channels)
    if n_channels == 1:
        return x.mean(dim=-1, keepdim=True)
    raise ValueError(f"cannot adapt {x.shape[-1]} channels to {n_channels}")
