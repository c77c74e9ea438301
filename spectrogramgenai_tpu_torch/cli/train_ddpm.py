"""Conditional DDPM trainer CLI (``spectrogramgenai_tpu/cli/train_ddpm.py``).

Pixel-space (``--latent false``) or VQ-VAE-latent diffusion on one device.
The latent path reads a port VQ-VAE checkpoint (``{"params": …}`` under
``--vqae_ckpt``) and, with ``--cache_latents`` (the default), encodes the
training set once. Checkpoints go to ``models/<run_name>`` (resumed exactly,
mid-epoch included), metrics and preview sample grids to
``<output_dir>/<run_name>``. ``--profile_dir`` traces the whole run with
``torch.profiler`` into ``<profile_dir>/trace.json`` (a Chrome trace; on the
card it names the attention kernels). Runs on CUDA unless ``--device`` says
otherwise.

  python -m spectrogramgenai_tpu_torch.cli.train_ddpm --data.dataset_path datasets \\
      --epochs 100 --vqae_ckpt models/vqvae --run.run_name ddpm
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def load_vq_variables(ckpt_dir: str) -> dict[str, torch.Tensor]:
    """The VQVAE state_dict of a port VQ-VAE checkpoint."""
    from spectrogramgenai_tpu_torch.cli.common import restore

    return restore(ckpt_dir, "VQ-VAE")["params"]


def run(cfg, device: str = "cuda"):
    """Train ``cfg`` for ``cfg.epochs`` epochs (resuming from ``models/<run_name>``); returns the TrainState."""
    from spectrogramgenai_tpu_torch.cli.common import resolve_device, setup
    from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager
    from spectrogramgenai_tpu_torch.core.metrics import MetricsLogger
    from spectrogramgenai_tpu_torch.data.latent_cache import LatentCacheSource
    from spectrogramgenai_tpu_torch.data.pipeline import (
        ImageFolderSource,
        device_prefetch,
        iterate_batches,
        padded_eval_batches,
    )
    from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask

    dev = resolve_device(device)
    setup(cfg.run)
    train_src = ImageFolderSource(
        os.path.join(cfg.data.dataset_path, cfg.data.train_folder),
        bootstrap_balance=cfg.data.bootstrap_balance, seed=cfg.run.seed, img_size=cfg.data.img_size,
        cache_decoded=cfg.data.cache_decoded, cache_budget_mb=cfg.data.cache_budget_mb,
    )
    # as in the JAX CLI, this draws (and so skips) one epoch of the source's stream
    steps_per_epoch = len(train_src.epoch_indices()) // cfg.data.batch_size
    total_steps = max(1, steps_per_epoch * cfg.epochs)

    vq_params = load_vq_variables(cfg.vqae_ckpt) if cfg.latent else None
    task = DiffusionTask(cfg, dev, vq_params=vq_params, total_steps=total_steps)
    state = task.init_state()
    use_cache = cfg.latent and cfg.cache_latents
    if use_cache:
        t0 = time.perf_counter()
        train_src = LatentCacheSource(train_src, task.make_encoder(), dev)
        print(f"latent cache: {len(train_src.labels)} images encoded in {time.perf_counter() - t0:.3f} s",
              flush=True)
    batch_key = "latent" if use_cache else "image"

    run_dir = os.path.join(cfg.run.output_dir, cfg.run.run_name)
    logger = MetricsLogger(run_dir)
    ckpt = CheckpointManager(os.path.join("models", cfg.run.run_name))
    saved = ckpt.restore()
    if saved is not None and "opt_state" not in saved:
        print(f"warning: the checkpoint under {ckpt.directory} holds no train state; starting fresh")
    elif saved is not None:
        task.load_state(state, saved)
        print(f"resumed from step {state.step}", flush=True)
    # exact mid-epoch resume: state.step counts the train batches consumed
    start_epoch = min(state.step // steps_per_epoch, cfg.epochs) if steps_per_epoch else 0
    resume_skip = state.step % steps_per_epoch if steps_per_epoch else 0

    val_root = os.path.join(cfg.data.dataset_path, cfg.data.val_folder)
    val_src = ImageFolderSource(val_root, img_size=cfg.data.img_size, cache_decoded=cfg.data.cache_decoded,
                                cache_budget_mb=cfg.data.cache_budget_mb) if os.path.isdir(val_root) else None

    for epoch in range(cfg.epochs):
        if epoch < start_epoch:
            train_src.epoch_indices()  # advance the shuffle / bootstrap stream
            continue
        skip = resume_skip if epoch == start_epoch else 0
        t0, steps, loss = time.perf_counter(), 0, None
        batches = iterate_batches(train_src, cfg.data.batch_size, epochs=1, skip_batches=skip)
        for batch in device_prefetch(batches, dev):
            state, m = task.train_step(state, batch[batch_key], batch["label"], encoded=use_cache)
            steps += 1
            loss = m["train_mse"]
            if state.step % cfg.run.log_every == 0:
                logger.log(state.step, epoch=epoch, train_mse=float(loss))
        if loss is not None:
            loss = float(loss)  # waits for the epoch's last step
            wall = time.perf_counter() - t0
            print(f"epoch {epoch}: {steps} steps in {wall:.3f} s, {wall / steps:.4f} s/step, "
                  f"{steps * cfg.data.batch_size / wall:.2f} images/s, train_mse {loss:.5f}", flush=True)
        if cfg.do_validation and val_src is not None:
            gen = torch.Generator(device=dev).manual_seed(epoch)
            vals = [float(task.eval_step(state, batch["image"], batch["label"], gen)["val_mse"])
                    for batch, _ in padded_eval_batches(val_src, 2 * cfg.data.batch_size, dev)]
            if vals:
                logger.log(state.step, epoch=epoch, val_mse=float(np.mean(vals)))
                print(f"epoch {epoch}: val_mse {np.mean(vals):.5f}", flush=True)
        if epoch % cfg.log_every_epoch == 0 or epoch == cfg.epochs - 1:
            _log_images(task, run_dir, epoch, logger, state.step)
        if epoch % cfg.run.ckpt_every_epochs == 0 or epoch == cfg.epochs - 1:
            saved_dir = ckpt.save(state.step, state.state_dict())
            logger.log_artifact(saved_dir, name="model", description="Model weights for DDPM conditional",
                                metadata={"epoch": epoch})
    logger.close()
    print(f"done; checkpoints under models/{cfg.run.run_name}")
    return state


def _log_images(task, run_dir: str, epoch: int, logger, step: int) -> None:
    """One preview sample per class with the config's preview sampler."""
    from spectrogramgenai_tpu_torch.audio.export import save_generated_pngs

    labels = torch.arange(task.cfg.num_classes)
    gen = torch.Generator(device=task.device).manual_seed(epoch)
    imgs = task.sample(labels, generator=gen, sampler=task.cfg.preview_sampler).cpu().numpy()
    out = os.path.join(run_dir, f"samples_epoch_{epoch:04d}")
    save_generated_pngs(imgs, [os.path.join(out, f"class_{i:02d}.png") for i in range(len(imgs))])
    logger.log_images(step, {"sampled_classes": np.concatenate(imgs[..., 0], axis=1)})


def main(argv=None):
    from spectrogramgenai_tpu_torch.core.config import DDPMConfig, add_config_args, apply_overrides
    from spectrogramgenai_tpu_torch.utils.profiling import trace

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of the run to <profile_dir>/trace.json")
    add_config_args(p, DDPMConfig)
    a = p.parse_args(argv)
    with trace(a.profile_dir):
        return run(apply_overrides(DDPMConfig(), a), device=a.device)


if __name__ == "__main__":
    main()
