"""Source-separation trainer CLI (``spectrogramgenai_tpu/cli/train_specunet.py``) on one device.

Reads a noise-recordings CSV and a bird-recordings CSV (columns ``path``,
``st``, ``common_name``; ``st`` read as pandas reads it), builds ε-mixed
spectrogram triples on the fly (``audio/mix.py``: 2¹⁷-sample windows, ε ~
U(0, 0.3) from ``np.random.default_rng(seed + epoch)``, the log-mel at the
rung ``--exact`` picks, as in ``cli.gen_specs``), and trains the separator
(``--mode separate``, 2 channels) or the denoiser (``--mode denoise``, the
noise channel) with MSE. Every ``run.ckpt_every_epochs`` epochs and at the
last it saves a checkpoint under ``models/<run_name>`` (by step; what
``cli.train_classifiers --denoiser_ckpt`` reads) and a separation figure
``sep_examples_epoch_XXX.png`` (columns mix, noise, predicted noise, bird,
predicted bird; the last is left out in denoise mode, which predicts no
bird) under ``<output_dir>/<run_name>``. Prints s/step and the split
load/resample (host), mel kernel, normalise and step (CUDA events on the
card). Runs on CUDA unless ``--device`` says otherwise.

  python -m spectrogramgenai_tpu_torch.cli.train_specunet --noise_csv noise.csv \\
      --bird_csv birds.csv --sample_rate 22050 --epochs 100
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np
import torch

WINDOW = 2**17  # the mixing dataset's window in samples


def read_rows(path: str) -> list[dict]:
    """A recordings CSV's rows, with ``st`` (where present) as pandas parses it."""
    from spectrogramgenai_tpu_torch.data.manifest import pandas_float

    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        if "st" in row:
            row["st"] = pandas_float(row["st"])
    return rows


def make_mix_batches(noise_rows: list[dict], bird_rows: list[dict], sr: int, batch_size: int, seed: int,
                     device: torch.device | str = "cuda", exact=True, timers: dict | None = None):
    """Batches of midpoint-normalised (noise, bird, mix) spectrogram triples,
    NHWC on ``device``, with the bird rows' labels. ``timers`` (a dict with
    "load" seconds and ``cli.common.DeviceTimer``s "kernel" and "normalise")
    accumulates the split where given."""
    from spectrogramgenai_tpu_torch.audio.mix import mix_batch_specs
    from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig
    from spectrogramgenai_tpu_torch.audio.wavio import fixed_window, load_wav

    rng = np.random.default_rng(seed)
    cfg = SpectrogramConfig(sample_rate=sr)
    n = min(len(noise_rows), len(bird_rows))
    order = rng.permutation(n)
    for start in range(0, n - batch_size + 1, batch_size):
        t0 = time.perf_counter()
        noise_wavs, bird_wavs, labels = [], [], []
        for i in order[start : start + batch_size]:
            nr, br = noise_rows[i], bird_rows[i]
            st = float(br.get("st", 0.0))
            noise_wavs.append(fixed_window(load_wav(nr["path"], target_sr=sr)[0], sr, st, WINDOW))
            bird_wavs.append(fixed_window(load_wav(br["path"], target_sr=sr)[0], sr, st, WINDOW))
            labels.append(br.get("common_name", ""))
        if timers is not None:
            timers["load"] += time.perf_counter() - t0
        eps = rng.uniform(0.0, 0.3, size=batch_size)
        noise_s, bird_s, mix_s = mix_batch_specs(np.stack(noise_wavs), np.stack(bird_wavs), eps, cfg, device,
                                                 exact=exact, timers=timers)
        yield {"noise": noise_s[..., None], "bird": bird_s[..., None], "mix": mix_s[..., None], "labels": labels}


def run(cfg, noise_csv: str, bird_csv: str, sample_rate: int = 22050, exact=True, device: str = "cuda"):
    """Train ``cfg`` for ``cfg.epochs`` epochs; returns (task, TrainState)."""
    from spectrogramgenai_tpu_torch.cli.common import DeviceTimer, resolve_device, setup
    from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager
    from spectrogramgenai_tpu_torch.core.metrics import MetricsLogger
    from spectrogramgenai_tpu_torch.ops.mel_kernel import rung_name
    from spectrogramgenai_tpu_torch.train.specunet_task import SpecUNetTask

    rung_name(exact)  # reject a bad value before any work
    dev = resolve_device(device)
    setup(cfg.run)
    task = SpecUNetTask(cfg, dev)
    state = task.init_state()

    run_dir = os.path.join(cfg.run.output_dir, cfg.run.run_name)
    logger = MetricsLogger(run_dir)
    ckpt = CheckpointManager(os.path.join("models", cfg.run.run_name))
    noise_rows, bird_rows = read_rows(noise_csv), read_rows(bird_csv)

    step_i, batch = 0, None
    for epoch in range(cfg.epochs):
        timers = {"load": 0.0, "kernel": DeviceTimer(dev), "normalise": DeviceTimer(dev)}
        step_timer, t0, steps, loss = DeviceTimer(dev), time.perf_counter(), 0, None
        for batch in make_mix_batches(noise_rows, bird_rows, sample_rate, cfg.data.batch_size, cfg.run.seed + epoch,
                                      dev, exact=exact, timers=timers):
            state, m = step_timer(lambda: task.train_step(state, batch["mix"], batch["noise"], batch["bird"]))
            step_i, steps, loss = step_i + 1, steps + 1, m["train_mse"]
            if step_i % cfg.run.log_every == 0:
                logger.log(step_i, epoch=epoch, train_mse=float(loss))
        if steps:
            loss = float(loss)  # waits for the epoch's last step
            wall = time.perf_counter() - t0
            clock = "CUDA events" if dev.type == "cuda" else "host"
            print(f"epoch {epoch}: {steps} steps in {wall:.3f} s, {wall / steps:.4f} s/step, train_mse {loss:.5f}; "
                  f"load/resample {timers['load']:.3f} s, mel kernel {timers['kernel'].seconds():.3f} s, "
                  f"normalise {timers['normalise'].seconds():.3f} s, step {step_timer.seconds():.3f} s ({clock})",
                  flush=True)
        if batch is not None and (epoch % cfg.run.ckpt_every_epochs == 0 or epoch == cfg.epochs - 1):
            ckpt.save(step_i, state.state_dict())
            _plot_separation(task, state, batch, run_dir, epoch)
    logger.close()
    return task, state


def _plot_separation(task, state, batch: dict, run_dir: str, epoch: int) -> None:
    """Up to 4 rows of mix, noise, predicted noise, bird and predicted bird as one PNG."""
    from spectrogramgenai_tpu_torch.audio.export import save_panel_grid

    pred_noise, pred_bird = task.separate(state, batch["mix"][:4])
    cols = [batch["mix"][:4], batch["noise"][:4], pred_noise, batch["bird"][:4]]
    if pred_bird.shape[-1]:  # denoise mode predicts no bird
        cols.append(pred_bird)
    cols = [c.float().cpu().numpy()[..., 0] for c in cols]
    rows = [[c[r] for c in cols] for r in range(len(cols[0]))]
    save_panel_grid(rows, os.path.join(run_dir, f"sep_examples_epoch_{epoch:03d}.png"))


def main(argv=None):
    from spectrogramgenai_tpu_torch.cli.gen_specs import EXACT_CHOICES
    from spectrogramgenai_tpu_torch.core.config import SpecUNetConfig, add_config_args, apply_overrides

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--noise_csv", required=True)
    p.add_argument("--bird_csv", required=True)
    p.add_argument("--sample_rate", type=int, default=22050)
    p.add_argument("--exact", default="1", choices=list(EXACT_CHOICES),
                   help="the mel rung, as cli.gen_specs takes it: 1 = the float64 FFT (default), high, 0")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    add_config_args(p, SpecUNetConfig)
    a = p.parse_args(argv)
    return run(apply_overrides(SpecUNetConfig(), a), a.noise_csv, a.bird_csv, a.sample_rate,
               exact=EXACT_CHOICES[a.exact], device=a.device)


if __name__ == "__main__":
    main()
