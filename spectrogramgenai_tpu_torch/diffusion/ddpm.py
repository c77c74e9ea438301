"""DDPM runtime in PyTorch: schedule, forward q-sample, ε-MSE loss and the
three samplers of ``spectrogramgenai_tpu/diffusion/ddpm.py``.

Differences from the JAX module, all forced by PyTorch:
  * ``lax.scan`` becomes a Python loop over the steps.
  * Randomness comes from an explicit ``torch.Generator``. Its stream is not
    JAX's, so every sampler also takes an injected starting noise ``x_T``
    (and ``ddpm_sample`` its per-step noise), and ``diffusion_loss`` its t,
    noise and label-keep flag, which is how the tests feed both packages the
    same numbers.
  * The model is a callable ``model_fn(x, t, y, cond_mask) → ε`` over NHWC
    float32 tensors (a module, or a closure over one).

The classifier-free-guidance trick is kept: each step runs ONE 2n-batch
forward with ``cond_mask`` = [1]*n + [0]*n.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
_f32 = np.float32


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    noise_steps: int
    beta_start: float
    beta_end: float

    @functools.cached_property
    def beta(self) -> np.ndarray:
        return np.linspace(self.beta_start, self.beta_end, self.noise_steps, dtype=np.float32)

    @functools.cached_property
    def alpha(self) -> np.ndarray:
        return 1.0 - self.beta

    @functools.cached_property
    def alpha_hat(self) -> np.ndarray:
        return np.cumprod(self.alpha, axis=0, dtype=np.float32)


def linear_schedule(noise_steps: int = 1000, beta_start: float = 1e-4, beta_end: float = 0.02):
    return DiffusionSchedule(noise_steps, beta_start, beta_end)


@functools.lru_cache(maxsize=8)
def _alpha_hat(schedule: DiffusionSchedule, device: torch.device) -> torch.Tensor:
    # cached on the device: the train step would otherwise copy the table
    # every step. Made outside inference mode, as models/layers.py's matrices
    with torch.inference_mode(False):
        return torch.from_numpy(schedule.alpha_hat).to(device)


def q_sample(schedule: DiffusionSchedule, x: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion x_t = √ᾱ_t·x + √(1 − ᾱ_t)·ε."""
    ah = _alpha_hat(schedule, x.device)[t]
    shape = (-1,) + (1,) * (x.dim() - 1)
    return torch.sqrt(ah).reshape(shape) * x + torch.sqrt(1.0 - ah).reshape(shape) * noise


def diffusion_loss(model_fn: ModelFn, schedule: DiffusionSchedule, x0: torch.Tensor,
                   labels: torch.Tensor, *, label_drop: float = 0.1,
                   generator: torch.Generator | None = None, t: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None, keep: torch.Tensor | float | None = None
                   ) -> torch.Tensor:
    """ε-prediction MSE (a float32 scalar) with classifier-free label dropout.

    t ~ U{1, …, noise_steps − 1} per sample, ε ~ N(0, 1), and ONE label-keep
    draw for the whole batch (kept with probability 1 − ``label_drop``), as
    the JAX loss draws them. Any of ``t``, ``noise`` and ``keep`` may be given
    instead; the rest come from ``generator``, in that order.
    """
    n, dev = x0.shape[0], x0.device
    if t is None:
        t = torch.randint(1, schedule.noise_steps, (n,), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=dev, dtype=x0.dtype)
    if keep is None:
        keep = torch.rand((), generator=generator, device=dev) >= label_drop
    cond_mask = torch.as_tensor(keep, dtype=torch.float32, device=dev).expand(n)
    pred = model_fn(q_sample(schedule, x0, t.to(dev), noise), t.to(dev, torch.float32), labels, cond_mask)
    return torch.mean((noise - pred) ** 2)


def _guided_eps(model_fn: ModelFn, x: torch.Tensor, t: float, labels: torch.Tensor,
                cfg_scale: float) -> torch.Tensor:
    """ε at timestep t; with cfg_scale > 0 the cond and uncond passes run as one 2n batch."""
    n = x.shape[0]
    tt = torch.full((n,), float(t), dtype=torch.float32, device=x.device)
    if cfg_scale > 0:
        mask = torch.cat([torch.ones(n, device=x.device), torch.zeros(n, device=x.device)])
        eps = model_fn(torch.cat([x, x]), torch.cat([tt, tt]), torch.cat([labels, labels]), mask)
        cond, uncond = eps[:n], eps[n:]
        return uncond + cfg_scale * (cond - uncond)
    return model_fn(x, tt, labels, torch.ones(n, device=x.device))


def _initial_noise(labels: torch.Tensor, sample_shape: tuple[int, ...],
                   generator: torch.Generator | None, x_T: torch.Tensor | None) -> torch.Tensor:
    shape = (labels.shape[0], *sample_shape)
    if x_T is not None:
        if tuple(x_T.shape) != shape:
            raise ValueError(f"x_T has shape {tuple(x_T.shape)}, expected {shape}")
        return x_T.to(device=labels.device, dtype=torch.float32)
    return torch.randn(shape, generator=generator, device=labels.device)


@torch.no_grad()
def ddpm_sample(model_fn: ModelFn, schedule: DiffusionSchedule, labels: torch.Tensor,
                sample_shape: tuple[int, ...], cfg_scale: float = 3.0, *,
                generator: torch.Generator | None = None, x_T: torch.Tensor | None = None,
                noise: torch.Tensor | None = None,
                callback: Callable[[int, torch.Tensor], None] | None = None) -> torch.Tensor:
    """Ancestral reverse chain over i = noise_steps-1 … 1.

    ``noise`` (optional) holds the per-step noise, (noise_steps-1, n,
    *sample_shape), in chain order; the last step (i = 1) adds none.
    ``callback(i, x)`` (optional) sees each step's output x_{i-1} (the
    trajectory dump of ``cli/generate.py``).
    """
    x = _initial_noise(labels, sample_shape, generator, x_T)
    steps = range(schedule.noise_steps - 1, 0, -1)
    if noise is not None and tuple(noise.shape) != (len(steps), *x.shape):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {(len(steps), *x.shape)}")
    for pos, i in enumerate(steps):
        eps = _guided_eps(model_fn, x, i, labels, cfg_scale)
        alpha, alpha_hat, beta = schedule.alpha[i], schedule.alpha_hat[i], schedule.beta[i]
        x = float(_f32(1.0) / np.sqrt(alpha)) * (
            x - float((_f32(1.0) - alpha) / np.sqrt(_f32(1.0) - alpha_hat)) * eps)
        if i > 1:
            z = noise[pos].to(x) if noise is not None else torch.randn(
                x.shape, generator=generator, device=x.device)
            x = x + float(np.sqrt(beta)) * z
        if callback is not None:
            callback(i, x)
    return x


@torch.no_grad()
def ddim_sample(model_fn: ModelFn, schedule: DiffusionSchedule, labels: torch.Tensor,
                sample_shape: tuple[int, ...], num_steps: int = 50, cfg_scale: float = 3.0,
                eta: float = 0.0, *, generator: torch.Generator | None = None,
                x_T: torch.Tensor | None = None) -> torch.Tensor:
    """DDIM (η=0: deterministic) on a ``num_steps`` subsequence of the schedule."""
    x = _initial_noise(labels, sample_shape, generator, x_T)
    ts = np.linspace(schedule.noise_steps - 1, 0, num_steps + 1).round().astype(np.int32)
    ah = schedule.alpha_hat
    for i, j in zip(ts[:-1], ts[1:]):  # current / previous timestep
        eps = _guided_eps(model_fn, x, i, labels, cfg_scale)
        a_t, a_prev = ah[i], ah[j]
        x0_pred = (x - float(np.sqrt(_f32(1.0) - a_t)) * eps) / float(np.sqrt(a_t))
        sigma = _f32(eta) * np.sqrt((_f32(1.0) - a_prev) / (_f32(1.0) - a_t) * (_f32(1.0) - a_t / a_prev))
        dir_x = float(np.sqrt(np.maximum(_f32(1.0) - a_prev - sigma**2, _f32(0.0)))) * eps
        x = float(np.sqrt(a_prev)) * x0_pred + dir_x
        if sigma > 0:
            x = x + float(sigma) * torch.randn(x.shape, generator=generator, device=x.device)
    return x


def dpmpp_timesteps(schedule: DiffusionSchedule, num_steps: int) -> np.ndarray:
    """Solver nodes uniform in log-SNR (λ), mapped to the integer t grid
    (see the JAX module for why uniform-λ and not uniform-t)."""
    if num_steps + 1 > schedule.noise_steps:
        raise ValueError(
            f"num_steps={num_steps} too large for a {schedule.noise_steps}-step "
            "schedule: timestep subsequence has duplicates (h=0)")
    lam_all = schedule.alpha_hat.astype(np.float64)
    lam_all = np.log(np.sqrt(lam_all) / np.sqrt(1.0 - lam_all))
    targets = np.linspace(lam_all[schedule.noise_steps - 1], lam_all[0], num_steps + 1)
    ts = np.array([int(np.abs(lam_all - L).argmin()) for L in targets], dtype=np.int32)
    ts[0], ts[-1] = schedule.noise_steps - 1, 0  # pin both chain endpoints
    for i in range(len(ts) - 2, 0, -1):  # λ moves fastest at t→0: repair
        ts[i] = max(ts[i], ts[i + 1] + 1)  # from the t=0 anchor outward…
    for i in range(1, len(ts)):
        ts[i] = min(ts[i], ts[i - 1] - 1)  # …then settle any top-end overlap
    if ts[-1] != 0 or np.any(np.diff(ts) >= 0):
        raise ValueError(
            f"num_steps={num_steps} too large for a {schedule.noise_steps}-step "
            "schedule: timestep subsequence has duplicates (h=0)")
    return ts


def dpmpp_coefficients(schedule: DiffusionSchedule, num_steps: int) -> dict[str, np.ndarray]:
    """Per-step float32 coefficients for :func:`dpmpp_sample` (lower_order_final
    below 15 steps, as in the JAX module)."""
    ts = dpmpp_timesteps(schedule, num_steps)
    if len(np.unique(ts)) != len(ts):
        raise ValueError(
            f"num_steps={num_steps} too large for a {schedule.noise_steps}-step "
            "schedule: timestep subsequence has duplicates (h=0)")
    ah = schedule.alpha_hat[ts].astype(np.float64)
    alpha = np.sqrt(ah)
    sigma = np.sqrt(1.0 - ah)
    lam = np.log(alpha / sigma)
    h = lam[1:] - lam[:-1]  # (num_steps,), > 0
    c2 = np.concatenate([[0.0], h[1:] / (2.0 * h[:-1])])
    if num_steps < 15:
        c2[-1] = 0.0  # lower_order_final
    return {
        "t": ts[:-1].astype(np.float32),
        "a_k": alpha[:-1].astype(np.float32),
        "s_k": sigma[:-1].astype(np.float32),
        "sig_ratio": (sigma[1:] / sigma[:-1]).astype(np.float32),
        "coef": (-alpha[1:] * np.expm1(-h)).astype(np.float32),
        "c2": c2.astype(np.float32),
    }


@torch.no_grad()
def dpmpp_sample(model_fn: ModelFn, schedule: DiffusionSchedule, labels: torch.Tensor,
                 sample_shape: tuple[int, ...], num_steps: int = 20, cfg_scale: float = 3.0, *,
                 generator: torch.Generator | None = None,
                 x_T: torch.Tensor | None = None) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022), stepping node k → k+1:

        D_k     = (1 + c2_k)·x0_k − c2_k·x0_{k−1}          (c2_0 = 0)
        x_{k+1} = (σ_{k+1}/σ_k)·x_k − α_{k+1}·expm1(−h_k)·D_k
    """
    x = _initial_noise(labels, sample_shape, generator, x_T)
    c = dpmpp_coefficients(schedule, num_steps)
    prev_x0 = torch.zeros_like(x)
    for k in range(num_steps):
        eps = _guided_eps(model_fn, x, c["t"][k], labels, cfg_scale)
        x0 = (x - float(c["s_k"][k]) * eps) / float(c["a_k"][k])
        d = float(_f32(1.0) + c["c2"][k]) * x0 - float(c["c2"][k]) * prev_x0
        x = float(c["sig_ratio"][k]) * x + float(c["coef"][k]) * d
        prev_x0 = x0
    return x


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """clamp(-1, 1) → [0, 255] uint8."""
    x = (torch.clamp(x, -1.0, 1.0) + 1.0) / 2.0
    return (x * 255.0).to(torch.uint8)
