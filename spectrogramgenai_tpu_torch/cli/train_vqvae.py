"""VQ-VAE trainer CLI (``spectrogramgenai_tpu/cli/train_vqvae.py``) on one device.

Trains ``--epochs`` epochs on ``<dataset_path>/<train_folder>``, resuming from
the run's checkpoint under ``models/<run_name>`` when there is one, and
evaluates on ``<val_folder>`` after each epoch with a reconstruction figure
(original / z / z_q / reconstruction rows) under ``<output_dir>/<run_name>``.
The checkpoint, saved under the state's step at the end, is what
``cli.train_ddpm --vqae_ckpt`` and ``cli.serve`` read: ``params`` holds the
VQVAE state_dict with its codebook, beside the Adam moments, step and rng.
Runs on CUDA unless ``--device`` says otherwise.

  python -m spectrogramgenai_tpu_torch.cli.train_vqvae --data.dataset_path datasets \\
      --data.train_folder train --data.val_folder val --epochs 10
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def run(cfg, device: str = "cuda"):
    """Train ``cfg`` for ``cfg.epochs`` more epochs; returns (task, TrainState)."""
    from spectrogramgenai_tpu_torch.cli.common import resolve_device, setup
    from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager
    from spectrogramgenai_tpu_torch.core.metrics import MetricsLogger
    from spectrogramgenai_tpu_torch.data.pipeline import (
        ImageFolderSource,
        device_prefetch,
        iterate_batches,
        padded_eval_batches,
    )
    from spectrogramgenai_tpu_torch.train.vqvae_task import VQVAETask

    dev = resolve_device(device)
    setup(cfg.run)
    task = VQVAETask(cfg, dev)
    state = task.init_state()

    run_dir = os.path.join(cfg.run.output_dir, cfg.run.run_name)
    logger = MetricsLogger(run_dir)
    ckpt = CheckpointManager(os.path.join("models", cfg.run.run_name))
    saved = ckpt.restore()
    if saved is not None and "opt_state" not in saved:
        print(f"warning: the checkpoint under {ckpt.directory} holds no train state; starting fresh")
    elif saved is not None:
        task.load_state(state, saved)
        print(f"resumed VQ-VAE from step {state.step}", flush=True)

    train_src = ImageFolderSource(
        os.path.join(cfg.data.dataset_path, cfg.data.train_folder),
        bootstrap_balance=cfg.data.bootstrap_balance, seed=cfg.run.seed, img_size=cfg.data.img_size,
        cache_decoded=cfg.data.cache_decoded, cache_budget_mb=cfg.data.cache_budget_mb,
    )
    val_root = os.path.join(cfg.data.dataset_path, cfg.data.val_folder)
    val_src = ImageFolderSource(val_root, img_size=cfg.data.img_size, cache_decoded=cfg.data.cache_decoded,
                                cache_budget_mb=cfg.data.cache_budget_mb) if os.path.isdir(val_root) else None
    # a resumed run goes on with the stream where the saved run left it, so
    # that n epochs and then m resumed ones see what n + m epochs see
    steps_per_epoch = train_src.epoch_size() // cfg.data.batch_size
    done_epochs, skip = divmod(state.step, steps_per_epoch) if steps_per_epoch else (0, 0)
    for _ in range(done_epochs):
        train_src.epoch_indices()

    for epoch in range(done_epochs, done_epochs + cfg.epochs):
        t0, steps, m = time.perf_counter(), 0, None
        batches = iterate_batches(train_src, cfg.data.batch_size, epochs=1, skip_batches=skip)
        skip = 0
        for batch in device_prefetch(batches, dev):
            state, m = task.train_step(state, batch["image"])
            steps += 1
            if state.step % cfg.run.log_every == 0:
                logger.log(state.step, epoch=epoch, **{k: float(v) for k, v in m.items()})
        if m is not None:
            m = {k: float(v) for k, v in m.items()}  # waits for the epoch's last step
            wall = time.perf_counter() - t0
            print(f"epoch {epoch}: {steps} steps in {wall:.3f} s, {wall / steps:.4f} s/step, "
                  f"{steps * cfg.data.batch_size / wall:.2f} images/s, loss {m['loss']:.5f}, "
                  f"recon_mse {m['recon_mse']:.5f}, perplexity {m['perplexity']:.2f}", flush=True)
        if val_src is not None:
            vals, last = [], None
            for batch, _ in padded_eval_batches(val_src, 2 * cfg.data.batch_size, dev):
                vals.append({k: float(v) for k, v in task.eval_step(state, batch["image"]).items()})
                last = batch["image"]
            mean = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]} if vals else {}
            logger.log(state.step, epoch=epoch, **mean)
            print(f"epoch {epoch}: {mean}", flush=True)
            if last is not None:
                _plot_reconstructions(task, state, last[:8], run_dir, epoch)
    ckpt.save(state.step, state.state_dict())
    logger.close()
    print(f"saved VQ-VAE step {state.step} to models/{cfg.run.run_name}")
    return task, state


def _plot_reconstructions(task, state, images: torch.Tensor, run_dir: str, epoch: int) -> None:
    """A 4-row figure for up to 4 images: the original, z and z_q (the latent's
    four channels as a 2×2 block) and the reconstruction."""
    from spectrogramgenai_tpu_torch.audio.export import save_panel_grid

    x_hat, z, z_q = (t.float().cpu().numpy() for t in task.reconstruct(state, images))
    images = images.float().cpu().numpy()
    n = min(4, len(images))

    def block(a: np.ndarray) -> np.ndarray:
        return np.block([[a[:, :, 0], a[:, :, 1]], [a[:, :, 2], a[:, :, 3]]])

    rows = [[images[i, :, :, 0] for i in range(n)], [block(z[i]) for i in range(n)],
            [block(z_q[i]) for i in range(n)], [x_hat[i, :, :, 0] for i in range(n)]]
    save_panel_grid(rows, os.path.join(run_dir, f"recon_epoch_{epoch:03d}.png"))


def main(argv=None):
    from spectrogramgenai_tpu_torch.core.config import VQVAEConfig, add_config_args, apply_overrides

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    add_config_args(p, VQVAEConfig)
    a = p.parse_args(argv)
    run(apply_overrides(VQVAEConfig(), a), device=a.device)


if __name__ == "__main__":
    main()
