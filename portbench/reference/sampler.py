"""Plain reference of the latent DDPM's schedule, its DPM-Solver++(2M)
chain with classifier-free guidance, the VQ decode to uint8 and the
training loss (ε-MSE), written from Ho et al. 2020 and Lu et al. 2022 with
the published settings (linear β from 1e-4 to 0.02 over 1000 steps; 20
solver nodes uniform in log-SNR, pinned to the integer grid). NumPy float64
for the schedule, :mod:`.nets` for the networks; nothing of the system
under test."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import nets


def alpha_hat(cfg: dict) -> np.ndarray:
    beta = np.linspace(cfg["beta_start"], cfg["beta_end"], cfg["noise_steps"], dtype=np.float64)
    return np.cumprod(1.0 - beta)


def dpmpp_nodes(cfg: dict, num_steps: int) -> np.ndarray:
    """``num_steps + 1`` integer timesteps from T-1 down to 0, as near as the
    grid allows to uniform in λ = log(α/σ), strictly decreasing."""
    ah = alpha_hat(cfg)
    lam = 0.5 * np.log(ah / (1.0 - ah))
    T = cfg["noise_steps"]
    targets = np.linspace(lam[T - 1], lam[0], num_steps + 1)
    ts = np.array([int(np.abs(lam - x).argmin()) for x in targets])
    ts[0], ts[-1] = T - 1, 0
    for i in range(len(ts) - 2, 0, -1):
        ts[i] = max(ts[i], ts[i + 1] + 1)
    for i in range(1, len(ts)):
        ts[i] = min(ts[i], ts[i - 1] - 1)
    return ts


def guided_eps(P, cfg, x, t, labels, scale, prec):
    n = x.shape[0]
    tt = torch.full((2 * n,), float(t), device=x.device)
    mask = torch.cat([torch.ones(n, device=x.device), torch.zeros(n, device=x.device)])
    eps = nets.unet(P, cfg, torch.cat([x, x]), tt, torch.cat([labels, labels]), mask, prec)
    cond, uncond = eps[:n], eps[n:]
    return uncond + scale * (cond - uncond)


@torch.no_grad()
def dpmpp_chain(P, cfg, x, labels, num_steps, prec="fp32"):
    """The chain from x_T (n, S, S, C) → its output latents, float32."""
    ts = dpmpp_nodes(cfg, num_steps)
    ah = alpha_hat(cfg)[ts]
    a, s = np.sqrt(ah), np.sqrt(1.0 - ah)
    lam = np.log(a / s)
    h = np.diff(lam)
    x = x.float()
    prev = torch.zeros_like(x)
    for k in range(num_steps):
        eps = guided_eps(P, cfg, x, ts[k], labels, cfg["cfg_scale"], prec)
        x0 = (x - s[k] * eps) / a[k]
        c2 = 0.0 if k == 0 or (num_steps < 15 and k == num_steps - 1) else h[k] / (2.0 * h[k - 1])
        d = (1.0 + c2) * x0 - c2 * prev
        x = (s[k + 1] / s[k]) * x - a[k + 1] * np.expm1(-h[k]) * d
        prev = x0
    return x


@torch.no_grad()
def decode_uint8(V, z, prec="fp32"):
    """Chain output → clamp → nearest code → VQ decode → uint8 (n, H, W, 1)."""
    z = z.float().clamp(-1.0, 1.0)
    b, hh, ww, d = z.shape
    q = V["codebook.embedding"][nets.nearest_code(z.reshape(-1, d), V["codebook.embedding"])].reshape(z.shape)
    img = nets.vq_decode(V, q, prec)
    return ((img.clamp(-1.0, 1.0) + 1.0) / 2.0 * 255.0).to(torch.uint8)


def diffusion_loss(P, cfg, x0, labels, t, noise, keep, prec="fp32"):
    """ε-MSE at integer timesteps ``t`` with the given noise; ``keep`` False drops every label."""
    ah = torch.as_tensor(alpha_hat(cfg), device=x0.device)[t].float()
    shape = (-1,) + (1,) * (x0.dim() - 1)
    xt = ah.sqrt().reshape(shape) * x0 + (1.0 - ah).sqrt().reshape(shape) * noise
    mask = torch.full((x0.shape[0],), float(bool(keep)), device=x0.device)
    pred = nets.unet(P, cfg, xt, t.float(), labels, mask, prec)
    return (noise - pred).square().mean()
