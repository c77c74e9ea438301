"""Optimizer, learning-rate schedule and gradient accumulation
(``spectrogramgenai_tpu/train/common.py``).

The schedule is a copy of optax's ``cosine_onecycle_schedule`` as a plain
function of the step, not torch's ``OneCycleLR`` (whose phase ends differ).
AdamW is ``torch.optim.AdamW``: b1 0.9, b2 0.999, eps outside the square
root, weight decay decoupled and scaled by the scheduled lr, which is the
update ``optax.adamw`` computes; Adam is ``torch.optim.Adam``, the update of
``optax.adam``. The JAX module's mesh sharding rules are TPU
code and are not here: the port trains on one device.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


def onecycle_lr(step: int, total_steps: int, peak_value: float, pct_start: float = 0.3,
                div_factor: float = 25.0, final_div_factor: float = 1e4) -> float:
    """optax.cosine_onecycle_schedule(transition_steps=total_steps, …)(step).

    Cosine from peak/div_factor up to peak over the first
    ``int(pct_start·total_steps)`` steps, then down to
    peak/(div_factor·final_div_factor) at ``total_steps``, flat after. A
    phase of zero steps (total_steps < 4) is skipped; optax divides 0 by 0
    there and returns NaN.
    """
    bounds = np.array([0, int(pct_start * total_steps), int(total_steps)])
    values = np.cumprod([peak_value / div_factor, div_factor, 1.0 / (div_factor * final_div_factor)])
    for i in range(2):
        if bounds[i] <= step < bounds[i + 1]:
            pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
            return float(values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (math.cos(math.pi * pct) + 1))
    return float(values[-1])


def make_adam(params: list[torch.Tensor], lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 outside the square root."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_adamw_onecycle(params: list[torch.Tensor], max_lr: float, total_steps: int, eps: float = 1e-5,
                        weight_decay: float = 0.01) -> tuple[torch.optim.AdamW, Callable[[int], float]]:
    """AdamW over ``params`` and its lr schedule; the caller sets the lr of
    each update from the step count before it (optax reads its count before
    the update, so the first update uses lr(0))."""
    total = max(total_steps, 1)

    def schedule(step: int) -> float:
        return onecycle_lr(step, total, max_lr)

    opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999), eps=eps, weight_decay=weight_decay)
    return opt, schedule


def microbatch_split(batch: dict[str, torch.Tensor], k: int) -> list[dict[str, torch.Tensor]]:
    """Cut every (n, …) tensor of ``batch`` into k microbatches of n/k rows."""
    out = [{} for _ in range(k)]
    for name, a in batch.items():
        if a.shape[0] % k:
            raise ValueError(f"batch {a.shape[0]} not divisible by grad_accum={k}")
        for i, part in enumerate(a.chunk(k)):
            out[i][name] = part
    return out


def microbatch_accumulate(loss_fn: Callable[[dict], tuple[torch.Tensor, dict[str, torch.Tensor]]],
                          microbatches: list[dict], params: list[torch.Tensor]
                          ) -> tuple[torch.Tensor, list[torch.Tensor], dict[str, torch.Tensor]]:
    """Run ``loss_fn`` and its backward on each microbatch in turn (only one
    microbatch's activations are live at a time) and return the mean loss,
    the mean float32 gradient of each of ``params`` and the mean of each of
    the auxiliary scalars (loss terms, accuracy …) that ``loss_fn`` returns
    beside its loss: the caller makes ONE optimizer update, one schedule
    tick, for the whole batch. State that the forward updates in place (the
    VQ-VAE's codebook, BatchNorm's running statistics) threads through the
    microbatches in order, as the JAX scan's carry does."""
    k = len(microbatches)
    total, grads, aux = None, None, {}
    for mb in microbatches:
        for p in params:
            p.grad = None
        loss, out = loss_fn(mb)
        loss.backward()
        g = [p.grad.float() for p in params]  # a fresh .grad each microbatch: no copy needed
        out = {name: v.detach() for name, v in out.items()}
        if grads is None:
            total, grads, aux = loss.detach(), g, out
        else:
            total = total + loss.detach()
            torch._foreach_add_(grads, g)
            aux = {name: aux[name] + v for name, v in out.items()}
    for p in params:
        p.grad = None
    if k > 1:
        total = total / k
        torch._foreach_div_(grads, float(k))
        aux = {name: v / k for name, v in aux.items()}
    return total, grads, aux


def optimizer_update(opt: torch.optim.Optimizer, masters: list[torch.Tensor], grads: list[torch.Tensor],
                     working: list[torch.Tensor]) -> None:
    """One update of the float32 ``masters`` from the working copy's float32
    ``grads``, then the working copy (``working``, the module's parameters,
    in its compute dtype) refreshed from the masters."""
    for m, g in zip(masters, grads, strict=True):
        m.grad = g
    opt.step()
    for m in masters:
        m.grad = None
    with torch.no_grad():
        torch._foreach_copy_(working, masters)
