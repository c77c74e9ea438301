"""Typed configuration for the port's slices: run, data, DDPM, VQ-VAE and
classifier configs plus CLI overrides.

A copy of the same classes in ``spectrogramgenai_tpu/core/config.py``, with
the same field names and defaults (a test holds them equal), so that a flag
means the same in both packages. The mesh and sharding fields of
``RunConfig`` are kept for that reason; the port runs on one device and
ignores them. The other workloads' configs (ACGAN, the denoiser) come with
their slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import types
import typing


@dataclasses.dataclass(frozen=True)
class RunConfig:
    run_name: str = "run"
    output_dir: str = "results"
    seed: int = 42
    log_every: int = 50
    ckpt_every_epochs: int = 10
    mesh_data: int = -1  # -1 = all devices
    mesh_model: int = 1
    # parameter/optimizer-state sharding over the mesh (train/common.py
    # SHARD_MODES): "tp" (default), "fsdp" (ZeRO-3 style over the data
    # axis), "tp_fsdp", or "replicate".
    param_sharding: str = "tp"
    use_wandb: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset_path: str = "datasets"
    train_folder: str = "train"
    val_folder: str = "val"
    img_size: int = 256
    batch_size: int = 10          # train_ddpm.py:31
    slice_size: int = 1
    num_workers: int = 4
    bootstrap_balance: bool = True  # BootstrappedImageFolder semantics (diff_utils.py:80-111)
    cache_decoded: bool = True    # decoded-image RAM cache (training data path)
    cache_budget_mb: int = 8192


@dataclasses.dataclass(frozen=True)
class DDPMConfig:
    """Conditional DDPM — pixel space or VQ-VAE latent space.

    Reference: diff_modules.py:370-442 (schedule/CFG), train_ddpm.py:18-44.
    """

    run: RunConfig = RunConfig(run_name="ddpm")
    data: DataConfig = DataConfig()
    epochs: int = 100
    noise_steps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    img_size: int = 256
    num_classes: int = 27
    c_in: int = 1
    c_out: int = 1
    time_dim: int = 256
    remove_deep_conv: bool = False
    width_mult: float = 1.0  # dev/test shrink knob; 1.0 = reference UNet
    latent: bool = True            # DiffusionVAE is the working reference path
    latent_dim: int = 4
    latent_downscale: int = 4      # img_size // 4 (diff_modules.py:621)
    vqae_ckpt: str = "models/VQAE"
    vq_hidden_dim: int = 512       # must match the trained VQ-VAE (diff_modules.py:609)
    vq_n_embeddings: int = 512
    lr: float = 5e-3               # AdamW max_lr with OneCycle (diff_modules.py:551-557)
    adam_eps: float = 1e-5
    cfg_scale: float = 3.0
    label_drop: float = 0.1        # classifier-free guidance dropout (diff_modules.py:475)
    ema_beta: float = 0.995
    ema_start: int = 2000
    do_validation: bool = True
    log_every_epoch: int = 10
    preview_sampler: str = "ddim"  # mid-training sample grids use the fast
    # sampler (50 steps); final generation defaults to the parity DDPM chain.
    rounds_per_chain: int = 1      # generation rounds batched into one chain
    compute_dtype: str = "bfloat16"  # replaces fp16 autocast + GradScaler
    grad_accum: int = 1            # microbatches per optimizer update (training)
    cache_latents: bool = True     # train from pre-encoded latents (training)


@dataclasses.dataclass(frozen=True)
class VQVAEConfig:
    """VQ-VAE with EMA codebook (``cli/train_vqvae.py``)."""

    run: RunConfig = RunConfig(run_name="vqvae")
    data: DataConfig = DataConfig(batch_size=16)
    epochs: int = 10
    input_dim: int = 1
    hidden_dim: int = 512
    latent_dim: int = 4
    n_embeddings: int = 512
    commitment_cost: float = 0.25
    ema_decay: float = 0.999
    ema_eps: float = 1e-5
    lr: float = 2e-4               # Adam
    compute_dtype: str = "bfloat16"
    grad_accum: int = 1            # microbatches per optimizer update


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    """Classifier sweep (``cli/train_classifiers.py``)."""

    run: RunConfig = RunConfig(run_name="classifiers")
    data: DataConfig = DataConfig(batch_size=16)
    model_name: str = "custom"     # resnet|vgg|mobilenet|custom|ensemble
    num_classes: int = 27
    epochs: int = 25
    lr: float = 1e-3               # Adam
    synthetic_per_class: int = 0   # sweep {0,50,100,150,200,250}
    synthetic_cap: int = 250       # only generated images with index < 250
    knowledge_dist: bool = False
    kd_temperature: float = 3.0
    kd_alpha: float = 0.7
    use_denoiser: bool = False     # the denoiser is not ported: True raises
    compute_dtype: str = "bfloat16"
    grad_accum: int = 1            # microbatches per optimizer update


def _flatten_fields(cls, prefix=""):
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        ftype = hints.get(f.name, f.type)
        origin = typing.get_origin(ftype)
        if origin is typing.Union or origin is types.UnionType:  # e.g. float | None
            args = [a for a in typing.get_args(ftype) if a is not type(None)]
            ftype = args[0] if args else str
        if dataclasses.is_dataclass(ftype):
            yield from _flatten_fields(ftype, prefix + f.name + ".")
        else:
            yield prefix + f.name, ftype


def add_config_args(parser: argparse.ArgumentParser, cls) -> None:
    """Expose every (nested) dataclass field as --dotted.path flags."""
    for path, ftype in _flatten_fields(cls):
        if ftype is bool:
            parser.add_argument(f"--{path}", type=lambda s: s.lower() in ("1", "true", "yes"), default=None)
        elif ftype in (int, float, str):
            parser.add_argument(f"--{path}", type=ftype, default=None)


def apply_overrides(cfg, args: argparse.Namespace):
    """Return a copy of cfg with any non-None --dotted.path overrides applied."""

    def _apply(obj, path: list[str], value):
        name = path[0]
        if len(path) == 1:
            return dataclasses.replace(obj, **{name: value})
        return dataclasses.replace(obj, **{name: _apply(getattr(obj, name), path[1:], value)})

    for key, value in vars(args).items():
        if value is None or "." not in key and not hasattr(cfg, key):
            continue
        path = key.split(".")
        if hasattr(cfg, path[0]):
            cfg = _apply(cfg, path, value)
    return cfg
