"""Shared CLI helpers: run setup, device selection and checkpoint loading."""

from __future__ import annotations

import logging
import os
import random

import numpy as np
import torch

from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager


def setup(run_cfg) -> None:
    """What every trainer CLI wants first: INFO logging, the host and torch
    RNGs seeded from ``run_cfg.seed``, and the run's output directory."""
    logging.basicConfig(format="%(asctime)s - %(levelname)s: %(message)s", level=logging.INFO,
                        datefmt="%I:%M:%S")
    np.random.seed(run_cfg.seed % (2**32 - 1))
    random.seed(run_cfg.seed)
    torch.manual_seed(run_cfg.seed)
    os.makedirs(os.path.join(run_cfg.output_dir, run_cfg.run_name), exist_ok=True)


def resolve_device(name: str) -> torch.device:
    """``--device`` → torch.device; asking for CUDA without a card is an error, not a fallback."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available (pass --device cpu to run on the CPU)")
    return device


def restore(directory: str, what: str) -> dict[str, dict[str, torch.Tensor]]:
    state = CheckpointManager(directory).restore()
    if state is None:
        raise FileNotFoundError(f"no {what} checkpoint under {directory}")
    return state


def load_task(cfg, device: torch.device, use_ema: bool = False):
    """DiffusionTask for ``cfg`` with the UNet weights of ``models/<run_name>``
    and, in latent mode, the VQ-VAE of ``cfg.vqae_ckpt``."""
    from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask

    vq_params = restore(cfg.vqae_ckpt, "VQ-VAE")["params"] if cfg.latent else None
    task = DiffusionTask(cfg, device, vq_params=vq_params)
    state = restore(os.path.join("models", cfg.run.run_name), "DDPM")
    task.load_params(state["ema_params" if use_ema else "params"])
    return task
