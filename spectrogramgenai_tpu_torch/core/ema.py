"""Exponential moving average of the parameters (``spectrogramgenai_tpu/core/ema.py``).

The EMA copy is part of the train state and is updated in place after every
optimizer update: during warmup (``step < step_start``) it copies the
parameters, after that ``ema = β·ema + (1 − β)·p``.
"""

from __future__ import annotations

import torch

from spectrogramgenai_tpu_torch.utils.profiling import span


@torch.no_grad()
def ema_init(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A real (non-aliased) copy of the params."""
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_update(ema_params: dict[str, torch.Tensor], params: dict[str, torch.Tensor], step: int,
               beta: float = 0.995, step_start: int = 2000) -> dict[str, torch.Tensor]:
    """Update ``ema_params`` in place and return it, in the span
    ``sgai.train.ema``. ``step`` is the train state's step before this
    update's increment, as in the JAX train step."""
    ema = list(ema_params.values())
    new = [params[k] for k in ema_params]
    with span("sgai.train.ema"):
        if step < step_start:
            torch._foreach_copy_(ema, new)
        else:
            torch._foreach_lerp_(ema, new, 1.0 - beta)  # e + (1 − β)(p − e)
    return ema_params
