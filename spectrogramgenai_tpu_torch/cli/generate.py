"""Conditional generation CLI (``spectrogramgenai_tpu/cli/generate.py``).

Loads a trained DDPM checkpoint and writes `num_samples` rounds of
one-image-per-class viridis PNGs named ``{class}_gen_imgs_{i}_{samp}.png``.

  python -m spectrogramgenai_tpu_torch.cli.generate --run.run_name ddpm \\
      --img_folder gen_images --num_samples 10 --start_idx 0
"""

from __future__ import annotations

import argparse
import os

import torch


def run(cfg, img_folder: str, num_samples: int, start_idx: int, class_names: list[str],
        use_ema: bool = False, sampler: str = "ddpm", num_steps: int = 50,
        device: str = "cuda"):
    from spectrogramgenai_tpu_torch.audio.export import save_generated_pngs
    from spectrogramgenai_tpu_torch.cli.common import load_task, resolve_device

    task = load_task(cfg, resolve_device(device), use_ema=use_ema)
    os.makedirs(img_folder, exist_ok=True)
    labels = torch.arange(cfg.num_classes)

    # k rounds per chain: one reverse chain over k·num_classes labels
    rounds_per_chain = max(1, min(cfg.rounds_per_chain, num_samples))
    samp_i = start_idx
    remaining = num_samples
    while remaining > 0:
        k = min(rounds_per_chain, remaining)
        generator = torch.Generator(device=task.device).manual_seed(samp_i)
        imgs = task.sample(labels.repeat(k), generator=generator, sampler=sampler,
                           num_steps=num_steps).cpu().numpy()
        out_paths = [
            os.path.join(img_folder, f"{class_names[lab]}_gen_imgs_{i}_{samp_i + r}.png")
            for r in range(k)
            for i, lab in enumerate(labels.tolist())
        ]
        save_generated_pngs(imgs, out_paths)
        print(f"sample rounds {samp_i}..{samp_i + k - 1}: wrote {len(out_paths)} images")
        samp_i += k
        remaining -= k


def main(argv=None):
    from spectrogramgenai_tpu_torch.core.config import DDPMConfig, add_config_args, apply_overrides

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--img_folder", default="gen_images")
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--start_idx", type=int, default=0)
    p.add_argument("--use_ema", type=int, default=0)
    p.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim", "dpmpp"],
                   help="ddpm = reference-parity 999-step chain; ddim = fast 1st-order "
                        "sampler; dpmpp = DPM-Solver++(2M), 2nd-order (~20 steps)")
    p.add_argument("--num_steps", type=int, default=50, help="DDIM/DPM-Solver++ steps")
    p.add_argument("--train_folder_for_classes", default=None,
                   help="derive class names from this folder's subdirs")
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
        a.sampler, a.num_steps, device=a.device)


if __name__ == "__main__":
    main()
