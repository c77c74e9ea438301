"""Shared CLI helpers: run setup (with the mesh of a distributed run), device
selection and checkpoint loading.

A port trainer started under ``torchrun`` (one process per rank) joins the
process group in :func:`setup` and trains over the (data, model) mesh of
``--run.mesh_data`` / ``--run.mesh_model`` with ``--run.param_sharding``;
rank 0 alone logs and writes files, the other ranks wait for it at
barriers (``cli.generate`` and ``cli.serve`` split their sampling over the
same mesh). Without ``torchrun`` the run is the one-rank run it always was.

  torchrun --standalone --nproc_per_node 8 -m spectrogramgenai_tpu_torch.cli.train_ddpm \\
      --run.param_sharding fsdp --data.batch_size 64 ...
"""

from __future__ import annotations

import json
import logging
import os
import random
import time

import numpy as np
import torch

from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager
from spectrogramgenai_tpu_torch.core.mesh import Mesh, MeshSpec, create_mesh, maybe_initialize_distributed


def setup(run_cfg, device: torch.device) -> Mesh:
    """What every trainer CLI wants first: INFO logging, the host and torch
    RNGs seeded from ``run_cfg.seed``, the run's output directory, and the
    mesh (:func:`make_mesh`)."""
    logging.basicConfig(format="%(asctime)s - %(levelname)s: %(message)s", level=logging.INFO,
                        datefmt="%I:%M:%S")
    np.random.seed(run_cfg.seed % (2**32 - 1))
    random.seed(run_cfg.seed)
    torch.manual_seed(run_cfg.seed)
    os.makedirs(os.path.join(run_cfg.output_dir, run_cfg.run_name), exist_ok=True)
    return make_mesh(run_cfg, device)


def make_mesh(run_cfg, device: torch.device) -> Mesh:
    """Join ``torchrun``'s process group if there is one (NCCL on the card,
    gloo on the CPU) and build the (``mesh_data``, ``mesh_model``) mesh of
    ``run_cfg``; a 1×1 mesh without ``torchrun``."""
    maybe_initialize_distributed(device)
    return create_mesh(MeshSpec(run_cfg.mesh_data, run_cfg.mesh_model), device)


def resolve_device(name: str) -> torch.device:
    """``--device`` → torch.device; asking for CUDA without a card is an error,
    not a fallback. Under ``torchrun`` an unnumbered ``cuda`` is this rank's
    card, ``cuda:$LOCAL_RANK``."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available (pass --device cpu to run on the CPU)")
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def rank_print(mesh: Mesh):
    """``print`` on rank 0; a function that prints nothing elsewhere."""
    return print if mesh.is_main else (lambda *args, **kwargs: None)


class _NoLogger:
    """The metrics sink of a rank other than 0: it writes nothing."""

    def log(self, *args, **kwargs):
        pass

    log_csv_row = log_artifact = log_images = close = log


def metrics_logger(mesh: Mesh, *args, **kwargs):
    """``core.metrics.MetricsLogger(*args, **kwargs)`` on rank 0; a sink that writes nothing elsewhere."""
    from spectrogramgenai_tpu_torch.core.metrics import MetricsLogger

    return MetricsLogger(*args, **kwargs) if mesh.is_main else _NoLogger()


def report_rank(mesh: Mesh, **extra) -> None:
    """In a distributed run, one JSON line per rank: its place in the mesh,
    the backend, the collectives it called, the kernel launches it made and
    the caller's ``extra`` fields."""
    if not mesh.distributed:
        return
    from spectrogramgenai_tpu_torch.ops.attention import fused_attention, fused_attention_bwd
    from spectrogramgenai_tpu_torch.ops.mel_kernel import fused_mel_power

    print("rank " + json.dumps({
        "rank": mesh.rank, "data_index": mesh.data_index, "model_index": mesh.model_index,
        "mesh": mesh.shape, "backend": mesh.backend(), "device": str(mesh.device),
        "collectives": dict(mesh.calls),
        "kernels": {"attention_fwd": fused_attention.launches, "attention_fwd_mma": fused_attention.mma_launches,
                    "attention_bwd": fused_attention_bwd.launches, "mel_power": fused_mel_power.launches},
        **extra}), flush=True)


def restore(directory: str, what: str) -> dict[str, dict[str, torch.Tensor]]:
    state = CheckpointManager(directory).restore()
    if state is None:
        raise FileNotFoundError(f"no {what} checkpoint under {directory}")
    return state


def load_task(cfg, device: torch.device, use_ema: bool = False, mesh: Mesh | None = None):
    """DiffusionTask for ``cfg`` (over ``mesh``, where given) with the UNet
    weights of ``models/<run_name>`` and, in latent mode, the VQ-VAE of
    ``cfg.vqae_ckpt``."""
    from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask

    vq_params = restore(cfg.vqae_ckpt, "VQ-VAE")["params"] if cfg.latent else None
    task = DiffusionTask(cfg, device, vq_params=vq_params, mesh=mesh)
    state = restore(os.path.join("models", cfg.run.run_name), "DDPM")
    task.load_params(state["ema_params" if use_ema else "params"])
    return task


class DeviceTimer:
    """Summed time of the calls it wraps: CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pending: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.cpu_seconds = 0.0

    def __call__(self, fn):
        if self.cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            self.pending.append((start, end))
            return out
        t0 = time.perf_counter()
        out = fn()
        self.cpu_seconds += time.perf_counter() - t0
        return out

    def seconds(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
            return sum(s.elapsed_time(e) for s, e in self.pending) / 1e3
        return self.cpu_seconds
