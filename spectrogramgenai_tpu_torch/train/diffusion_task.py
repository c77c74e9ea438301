"""Conditional DDPM task, sampling half (``spectrogramgenai_tpu/train/diffusion_task.py``).

Builds the UNet (and, in latent mode, the VQ-VAE) for a ``DDPMConfig`` on
one device, and samples: reverse chain → [clamp → codebook quantize → VQ
decode] → clamp → uint8. The attention kernel is on when the device is CUDA,
as the JAX task turns the Pallas kernel on when the backend is a TPU.

Weights live in the modules (``load_params``), in the config's compute
dtype; the codebook stays float32. Training (``init_state``, the train
step, the encoder for latent caching) comes in a later slice.
"""

from __future__ import annotations

import torch

from spectrogramgenai_tpu_torch.core.config import DDPMConfig
from spectrogramgenai_tpu_torch.diffusion.ddpm import (
    DiffusionSchedule,
    ddim_sample,
    ddpm_sample,
    dpmpp_sample,
    linear_schedule,
    to_uint8,
)
from spectrogramgenai_tpu_torch.models.unet import ConditionalUNet
from spectrogramgenai_tpu_torch.models.vqvae import VQVAE

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DiffusionTask:
    def __init__(self, cfg: DDPMConfig, device: torch.device | str,
                 vq_params: dict[str, torch.Tensor] | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = _DTYPES[cfg.compute_dtype]
        self.schedule: DiffusionSchedule = linear_schedule(cfg.noise_steps, cfg.beta_start, cfg.beta_end)

        if cfg.latent:
            if vq_params is None:
                raise ValueError("latent diffusion needs trained VQ-VAE weights (cfg.vqae_ckpt)")
            self.sample_size = cfg.img_size // cfg.latent_downscale
            self.channels = cfg.latent_dim
            self.vqvae = VQVAE(hidden_dim=cfg.vq_hidden_dim, latent_dim=cfg.latent_dim,
                               n_embeddings=cfg.vq_n_embeddings)
            self.vqvae.load_state_dict(vq_params)
            self.vqvae.to(self.device).eval()
            self.vqvae.encoder.to(self.dtype)
            self.vqvae.decoder.to(self.dtype)
        else:
            self.sample_size = cfg.img_size
            self.channels = cfg.c_in
            self.vqvae = None

        self.model = ConditionalUNet(c_in=self.channels, c_out=self.channels, time_dim=cfg.time_dim,
                                     num_classes=cfg.num_classes, remove_deep_conv=cfg.remove_deep_conv,
                                     width_mult=cfg.width_mult, fused_attention=self.device.type == "cuda")
        self.model.to(device=self.device, dtype=self.dtype).eval()

    def load_params(self, params: dict[str, torch.Tensor]) -> None:
        """Copy a UNet state_dict (e.g. a checkpoint's params or ema_params) into the model."""
        self.model.load_state_dict(params)

    # -- sampling ----------------------------------------------------------------
    @torch.inference_mode()
    def sample_latents(self, labels, *, generator: torch.Generator | None = None,
                       x_T: torch.Tensor | None = None, cfg_scale: float | None = None,
                       sampler: str = "ddpm", num_steps: int = 50) -> torch.Tensor:
        """The reverse chain alone: (n, S, S, C) float32, before any clamp."""
        cfg_scale = self.cfg.cfg_scale if cfg_scale is None else cfg_scale
        labels = torch.as_tensor(labels, dtype=torch.long, device=self.device)
        shape = (self.sample_size, self.sample_size, self.channels)
        kw = dict(generator=generator, x_T=x_T)
        if sampler == "ddim":
            return ddim_sample(self.model, self.schedule, labels, shape, num_steps=num_steps,
                               cfg_scale=cfg_scale, **kw)
        if sampler == "dpmpp":
            return dpmpp_sample(self.model, self.schedule, labels, shape, num_steps=num_steps,
                                cfg_scale=cfg_scale, **kw)
        if sampler == "ddpm":
            return ddpm_sample(self.model, self.schedule, labels, shape, cfg_scale=cfg_scale, **kw)
        raise ValueError(f"unknown sampler {sampler!r}")

    @torch.inference_mode()
    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """Chain output → uint8 images (n, H, W, 1); latent mode quantizes and decodes first."""
        if self.vqvae is not None:
            x = self.vqvae.decode_quantized(torch.clamp(x, -1.0, 1.0))
        return to_uint8(x)

    def sample(self, labels, *, generator: torch.Generator | None = None,
               x_T: torch.Tensor | None = None, cfg_scale: float | None = None,
               sampler: str = "ddpm", num_steps: int = 50) -> torch.Tensor:
        """Generate uint8 samples (n, H, W, 1) on the task's device."""
        x = self.sample_latents(labels, generator=generator, x_T=x_T, cfg_scale=cfg_scale,
                                sampler=sampler, num_steps=num_steps)
        return self.decode(x)
