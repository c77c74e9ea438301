"""ACGAN trainer CLI (``spectrogramgenai_tpu/cli/train_acgan.py``) on one device.

Image-folder input (each class a subdirectory of
``<dataset_path>/<train_folder>``), or the reference's manifest mode
(``--manifest specdata.npz``: its train split, named by the columns of
``--lab_csv``, the images under ``--im_path``; with ``--use_aind true`` and
``--ai_csv``, the acoustic indices merged in and z-normalised); a per-epoch ``training_results.csv``
with the reference's columns (Epoch, Loss_D, Loss_G, Loss_A — the last is
the discriminator's class accuracy); an eval-noise sample grid
``fake_samples_epoch_XXX.png`` every ``sample_every`` batches; checkpoints
under ``models/<run_name>`` every 10 epochs and at the last, named by the
epoch. ``--st_epochs`` resumes from the checkpoint of that epoch, rounded
down to a multiple of 10. As in the JAX CLI the epochs run from
``st_epochs + 1`` to ``epochs − 1``, and no denoiser is passed to the task
whatever ``--use_denoiser`` says (ROADMAP queue 3). Runs on CUDA unless
``--device`` says otherwise.

  python -m spectrogramgenai_tpu_torch.cli.train_acgan --data.dataset_path datasets \\
      --data.train_folder train --epochs 200
  python -m spectrogramgenai_tpu_torch.cli.train_acgan --manifest specdata.npz --lab_csv labels.csv \\
      --im_path images [--use_aind true --ai_csv indices.csv]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

INDEX_COLUMNS = ["ACI", "ADiv", "AEve", "BioA", "H", "Ht", "M", "NDSI", "NDSIAnthro", "NDSIBio", "AR"]


def manifest_source(cfg, manifest: str, lab_csv: str | None, ai_csv: str | None, im_path: str):
    """The manifest mode's source (JAX ``cli/train_acgan._manifest_source``):
    the ``specdata.npz`` train split with the columns ``index0`` + the label
    CSV's header; with ``cfg.use_aind`` and ``ai_csv``, its inner merge with
    the acoustic-index CSV on (file_name = file_path, begin_time, end_time) in
    pandas' row order, and each index column z-normalised (ddof 0, float64).
    Returns (DataFrameImageSource, class names)."""
    from spectrogramgenai_tpu_torch.data.manifest import (
        inner_merge,
        load_specdata_manifest,
        read_csv_table,
        zscore_columns,
    )
    from spectrogramgenai_tpu_torch.data.pipeline import DataFrameImageSource

    columns = None
    if lab_csv:
        columns = ["index0"] + read_csv_table(lab_csv)[0]
    rows, _test, classes = load_specdata_manifest(manifest, columns)
    indices_columns = None
    if cfg.use_aind and ai_csv:
        indices_columns = INDEX_COLUMNS
        rows = inner_merge(rows, read_csv_table(ai_csv)[1], ["file_name", "begin_time", "end_time"],
                           ["file_path", "begin_time", "end_time"])
        zscore_columns(rows, indices_columns)
    src = DataFrameImageSource(rows, im_path, classes, indices_columns=indices_columns, seed=cfg.run.seed,
                               cache_decoded=cfg.data.cache_decoded, cache_budget_mb=cfg.data.cache_budget_mb)
    return src, classes


def run(cfg, st_epochs: int = 0, manifest: str | None = None, device: str = "cuda", lab_csv: str | None = None,
        ai_csv: str | None = None, im_path: str = "."):
    """Train ``cfg``; returns (task, GANTrainState)."""
    from spectrogramgenai_tpu_torch.audio.export import save_generated_pngs
    from spectrogramgenai_tpu_torch.cli.common import resolve_device, setup
    from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager
    from spectrogramgenai_tpu_torch.core.metrics import MetricsLogger
    from spectrogramgenai_tpu_torch.data.pipeline import ImageFolderSource, device_prefetch, iterate_batches
    from spectrogramgenai_tpu_torch.train.acgan_task import ACGANTask

    dev = resolve_device(device)
    setup(cfg.run)
    task = ACGANTask(cfg, dev)
    state = task.init_state()

    run_dir = os.path.join(cfg.run.output_dir, cfg.run.run_name)
    logger = MetricsLogger(run_dir, csv_name="training_results.csv", csv_columns=["Epoch", "Loss_D", "Loss_G", "Loss_A"])
    ckpt = CheckpointManager(os.path.join("models", cfg.run.run_name))
    if st_epochs > 0:
        st_epochs = 10 * (st_epochs // 10)
        saved = ckpt.restore(st_epochs)
        if saved is not None:
            task.load_state(state, saved)
            print(f"resumed ACGAN from epoch {st_epochs} (step {state.step})", flush=True)

    if manifest:
        src, _classes = manifest_source(cfg, manifest, lab_csv, ai_csv, im_path)
    else:
        src = ImageFolderSource(os.path.join(cfg.data.dataset_path, cfg.data.train_folder), seed=cfg.run.seed,
                                img_size=cfg.data.img_size, cache_decoded=cfg.data.cache_decoded,
                                cache_budget_mb=cfg.data.cache_budget_mb)

    # fixed eval noise, drawn once from the run's seed
    gen = torch.Generator(device=dev).manual_seed(cfg.run.seed)
    eval_labels = torch.randint(0, cfg.num_classes, (cfg.data.batch_size,), generator=gen, device=dev)
    eval_noise = task.build_noise(eval_labels, generator=gen)

    for epoch in range(st_epochs + 1, cfg.epochs):
        t0, n_batches = time.perf_counter(), 0
        sums = {"loss_G": 0.0, "loss_D": 0.0, "d_acc": 0.0}
        for i, batch in enumerate(device_prefetch(iterate_batches(src, cfg.data.batch_size, epochs=1), dev)):
            state, m = task.train_step(state, batch["image"], batch["label"], batch.get("a_ind"))
            sums = {k: v + m[k] for k, v in sums.items()}  # summed on the device: no sync a step
            n_batches += 1
            if i % cfg.sample_every == 0:
                grid = _image_grid(task.generate(state, eval_noise).cpu().numpy())
                save_generated_pngs(grid[None], [os.path.join(run_dir, f"fake_samples_epoch_{epoch:03d}.png")])
                print(f"[{epoch}/{cfg.epochs}][{i}] Loss_D: {float(m['loss_D']):.4f} "
                      f"Loss_G: {float(m['loss_G']):.4f} Acc: {float(m['d_acc']):.4f}", flush=True)
        row = {k: float(v) / max(1, n_batches) for k, v in sums.items()}  # waits for the epoch's last step
        wall = time.perf_counter() - t0
        logger.log(state.step, epoch=epoch, **row)
        logger.log_csv_row({"Epoch": epoch, "Loss_D": row["loss_D"], "Loss_G": row["loss_G"], "Loss_A": row["d_acc"]})
        print(f"epoch {epoch}: {n_batches} steps in {wall:.3f} s, {wall / max(1, n_batches):.4f} s/step, "
              f"{n_batches * cfg.data.batch_size / wall:.2f} images/s, Loss_D {row['loss_D']:.4f}, "
              f"Loss_G {row['loss_G']:.4f}, d_acc {row['d_acc']:.4f}", flush=True)
        if epoch % 10 == 0 or epoch == cfg.epochs - 1:
            ckpt.save(epoch, state.state_dict())
    logger.close()
    return task, state


def _image_grid(imgs: np.ndarray, cols: int = 4) -> np.ndarray:
    """[-1, 1] NHWC1 batch → a uint8 grid, ``cols`` images a row."""
    imgs = ((np.clip(imgs, -1, 1) + 1) / 2 * 255).astype(np.uint8)[..., 0]
    n, h, w = imgs.shape
    rows = -(-n // cols)
    grid = np.zeros((rows * h, cols * w), np.uint8)
    for i, img in enumerate(imgs):
        r, c = divmod(i, cols)
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = img
    return grid


def main(argv=None):
    from spectrogramgenai_tpu_torch.core.config import ACGANConfig, add_config_args, apply_overrides

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--st_epochs", type=int, default=0)
    p.add_argument("--manifest", default=None, help="specdata.npz (manifest mode)")
    p.add_argument("--lab_csv", default=None, help="label CSV providing the manifest's columns")
    p.add_argument("--ai_csv", default=None, help="acoustic-index CSV (with --use_aind true)")
    p.add_argument("--im_path", default=".", help="spectrogram image folder for manifest mode")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    add_config_args(p, ACGANConfig)
    a = p.parse_args(argv)
    return run(apply_overrides(ACGANConfig(), a), a.st_epochs, a.manifest, device=a.device, lab_csv=a.lab_csv,
               ai_csv=a.ai_csv, im_path=a.im_path)


if __name__ == "__main__":
    main()
