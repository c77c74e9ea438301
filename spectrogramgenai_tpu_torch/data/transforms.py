"""On-device batch transforms (torch, NHWC), after ``spectrogramgenai_tpu/data/transforms.py``."""

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
