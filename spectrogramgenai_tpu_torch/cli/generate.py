"""Conditional generation CLI (``spectrogramgenai_tpu/cli/generate.py``).

Loads a trained DDPM checkpoint and writes `num_samples` rounds of
one-image-per-class viridis PNGs named ``{class}_gen_imgs_{i}_{samp}.png``;
with ``--audio_dir`` also each sample inverted to ``{png stem}.wav`` (the
inversion of ``cli.spec_to_wav``, on the same device, without the PNG round
trip). ``--sav_denoise_path DIR`` writes, instead of final images, the
reference's denoising trajectory: the 999-step DDPM chain (with CFG) over one
label per class, and at steps 999, every multiple of 50 and 1 the 2×2 grid of
the 4 latent channels and the VQ decode of each sample,
``{class}_noise_{i}_latent.png`` and ``{class}_noise_{i}_decode.png``.
``--artifact PATH`` generates from an exported sampler (cli.export_model)
instead of a checkpoint: no config and no model code, the artifact's sampler,
steps and CFG scale; its label batch must be k·num_classes.

  python -m spectrogramgenai_tpu_torch.cli.generate --run.run_name ddpm \\
      --img_folder gen_images --num_samples 10 --start_idx 0 [--audio_dir gen_audio]
  python -m spectrogramgenai_tpu_torch.cli.generate --artifact models/ddpm_sampler.zip \\
      --train_folder_for_classes datasets/train --num_samples 10
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def run(cfg, img_folder: str, num_samples: int, start_idx: int, class_names: list[str],
        use_ema: bool = False, sampler: str = "ddpm", num_steps: int = 50,
        device: str = "cuda", audio_dir: str | None = None, audio_out_sr: int | None = None,
        sav_denoise_path: str | None = None, artifact: str | None = None):
    from spectrogramgenai_tpu_torch.cli.common import load_task, resolve_device

    if artifact:
        return _run_from_artifact(artifact, img_folder, num_samples, start_idx, class_names,
                                  device=device, audio_dir=audio_dir, audio_out_sr=audio_out_sr)
    task = load_task(cfg, resolve_device(device), use_ema=use_ema)
    os.makedirs(img_folder, exist_ok=True)
    labels = torch.arange(cfg.num_classes)

    if sav_denoise_path:
        generator = torch.Generator(device=task.device).manual_seed(0)
        dump_denoise_trajectory(task, labels, class_names, sav_denoise_path, generator=generator)
        print("not saving images, just noise portions")  # the reference's message
        return

    def sample(seed: int, k: int) -> np.ndarray:  # k rounds: one reverse chain over k·num_classes labels
        generator = torch.Generator(device=task.device).manual_seed(seed)
        return task.sample(labels.repeat(k), generator=generator, sampler=sampler,
                           num_steps=num_steps).cpu().numpy()

    _write_rounds(sample, max(1, min(cfg.rounds_per_chain, num_samples)), img_folder, num_samples, start_idx,
                  [class_names[lab] for lab in labels.tolist()], audio_dir, audio_out_sr, task.device)


def _run_from_artifact(artifact_path: str, img_folder: str, num_samples: int, start_idx: int,
                       class_names: list[str], device: str = "cuda", audio_dir: str | None = None,
                       audio_out_sr: int | None = None):
    """Generate from an exported sampler: no checkpoint, config or model code;
    the artifact froze the sampler, steps and CFG scale. Its label batch must
    be k·num_classes, so that the naming contract holds."""
    from spectrogramgenai_tpu_torch.cli.common import resolve_device
    from spectrogramgenai_tpu_torch.serving.export import load_artifact

    art = load_artifact(artifact_path, device=resolve_device(device))
    ncls = art.manifest["num_classes"]
    if len(class_names) != ncls:
        raise ValueError(f"artifact has {ncls} classes, got {len(class_names)} names")
    if art.num_labels % ncls:
        raise ValueError(f"artifact label batch {art.num_labels} is not a multiple of num_classes {ncls}")
    labels = np.tile(np.arange(ncls), art.num_labels // ncls)
    os.makedirs(img_folder, exist_ok=True)
    _write_rounds(lambda seed, k: art(seed, labels)[: k * ncls], art.num_labels // ncls, img_folder,
                  num_samples, start_idx, class_names, audio_dir, audio_out_sr, art.device)


def _write_rounds(sample, rounds_per_chain: int, img_folder: str, num_samples: int, start_idx: int,
                  class_names: list[str], audio_dir: str | None, audio_out_sr: int | None,
                  device: torch.device) -> None:
    """Write ``num_samples`` rounds of one image per class, named
    ``{class}_gen_imgs_{i}_{samp}.png``; ``sample(seed, k)`` gives k rounds
    as (k·num_classes, H, W, 1) uint8 from one chain seeded with ``seed``
    (the round's index)."""
    from spectrogramgenai_tpu_torch.audio.export import save_generated_pngs

    samp_i = start_idx
    remaining = num_samples
    while remaining > 0:
        k = min(rounds_per_chain, remaining)
        imgs = sample(samp_i, k)
        out_paths = [os.path.join(img_folder, f"{name}_gen_imgs_{i}_{samp_i + r}.png")
                     for r in range(k) for i, name in enumerate(class_names)]
        save_generated_pngs(imgs, out_paths)
        if audio_dir:
            _write_audio(imgs, out_paths, audio_dir, audio_out_sr, device=device)
        print(f"sample rounds {samp_i}..{samp_i + k - 1}: wrote {len(out_paths)} images")
        samp_i += k
        remaining -= k


def trajectory_steps(noise_steps: int) -> set[int]:
    """The chain steps the dump writes: the first (noise_steps − 1), every multiple of 50, and 1."""
    return {i for i in range(noise_steps - 1, 0, -1) if i % 50 == 0 or i in (1, noise_steps - 1)}


def latent_grid_uint8(x: np.ndarray) -> np.ndarray:
    """Clipped latents (n, S, S, 4) → (n, 2S, 2S) uint8: channels 0 1 / 2 3 in a 2×2 grid, (x + 1) / 2 · 255."""
    grid = np.concatenate([np.concatenate([x[..., 0], x[..., 1]], axis=2),
                           np.concatenate([x[..., 2], x[..., 3]], axis=2)], axis=1)
    return ((grid + 1) / 2 * 255).astype(np.uint8)


@torch.inference_mode()
def dump_denoise_trajectory(task, labels, class_names: list[str], out_dir: str, *,
                            generator: torch.Generator | None = None, x_T: torch.Tensor | None = None,
                            noise: torch.Tensor | None = None) -> torch.Tensor:
    """Run the DDPM chain over ``labels`` (with the config's CFG scale) and,
    at each step of :func:`trajectory_steps`, write every sample's latent
    grid and VQ decode as viridis PNGs under ``out_dir``. Only those steps
    leave the device. ``x_T`` and ``noise`` as in ``ddpm_sample``. Returns the
    chain's last state (before any clamp)."""
    from spectrogramgenai_tpu_torch.audio.export import save_generated_pngs
    from spectrogramgenai_tpu_torch.diffusion.ddpm import ddpm_sample

    if task.vqvae is None or task.channels != 4:
        raise ValueError("the trajectory dump needs the latent model (4 latent channels and the VQ-VAE)")
    os.makedirs(out_dir, exist_ok=True)
    labels = torch.as_tensor(labels, dtype=torch.long, device=task.device)
    names = [class_names[lab] for lab in labels.tolist()]
    want = trajectory_steps(task.schedule.noise_steps)

    def save(i: int, x: torch.Tensor) -> None:
        if i not in want:
            return
        x = torch.clamp(x, -1.0, 1.0)
        save_generated_pngs(latent_grid_uint8(x.cpu().numpy()),
                            [os.path.join(out_dir, f"{n}_noise_{i}_latent.png") for n in names])
        save_generated_pngs(task.decode(x).cpu().numpy(),
                            [os.path.join(out_dir, f"{n}_noise_{i}_decode.png") for n in names])

    return ddpm_sample(task.model, task.schedule, labels, (task.sample_size, task.sample_size, task.channels),
                       cfg_scale=task.cfg.cfg_scale, generator=generator, x_T=x_T, noise=noise, callback=save)


def _write_audio(imgs_uint8, png_paths: list[str], audio_dir: str, out_sr: int | None,
                 device: torch.device | str = "cuda") -> None:
    """Invert the in-memory uint8 samples on ``device`` and write
    ``{png stem}.wav`` for each image name under ``audio_dir``."""
    from spectrogramgenai_tpu_torch.audio.invert import AudioReconstructor
    from spectrogramgenai_tpu_torch.audio.wavio import save_wav

    os.makedirs(audio_dir, exist_ok=True)
    wavs, sr = AudioReconstructor(out_sr=out_sr, device=device).waveforms(imgs_uint8)
    for wav, png_path in zip(wavs, png_paths, strict=True):
        stem = os.path.splitext(os.path.basename(png_path))[0]
        save_wav(os.path.join(audio_dir, stem + ".wav"), wav, sr)


def main(argv=None):
    from spectrogramgenai_tpu_torch.core.config import DDPMConfig, add_config_args, apply_overrides

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--img_folder", default="gen_images")
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--start_idx", type=int, default=0)
    p.add_argument("--sav_denoise_path", default=None,
                   help="write the 999-step chain's latent grids and VQ decodes every 50 steps here, "
                        "instead of final images")
    p.add_argument("--use_ema", type=int, default=0)
    p.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim", "dpmpp"],
                   help="ddpm = reference-parity 999-step chain; ddim = fast 1st-order "
                        "sampler; dpmpp = DPM-Solver++(2M), 2nd-order (~20 steps)")
    p.add_argument("--num_steps", type=int, default=50, help="DDIM/DPM-Solver++ steps")
    p.add_argument("--artifact", default=None,
                   help="generate from an exported sampler (cli.export_model) instead of a checkpoint")
    p.add_argument("--train_folder_for_classes", default=None,
                   help="derive class names from this folder's subdirs")
    p.add_argument("--audio_dir", default=None,
                   help="also reconstruct each sample to WAV (Griffin-Lim inversion, as cli.spec_to_wav) "
                        "into this folder")
    p.add_argument("--audio_out_sr", type=int, default=None,
                   help="resample reconstructed audio (e.g. 48000 for CLAP FAD)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    add_config_args(p, DDPMConfig)
    a = p.parse_args(argv)
    cfg = apply_overrides(DDPMConfig(), a)

    if a.train_folder_for_classes:
        from spectrogramgenai_tpu_torch.data.manifest import class_names_from_folder

        class_names = class_names_from_folder(a.train_folder_for_classes)
    else:
        class_names = [f"class{i:02d}" for i in range(cfg.num_classes)]

    run(cfg, a.img_folder, a.num_samples, a.start_idx, class_names, bool(a.use_ema),
        a.sampler, a.num_steps, device=a.device, audio_dir=a.audio_dir, audio_out_sr=a.audio_out_sr,
        sav_denoise_path=a.sav_denoise_path, artifact=a.artifact)


if __name__ == "__main__":
    main()
