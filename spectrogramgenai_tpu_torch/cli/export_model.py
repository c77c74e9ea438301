"""Export a trained DDPM sampler to a self-contained artifact
(``spectrogramgenai_tpu/cli/export_model.py``).

The artifact bakes in the weights, schedule, CFG scale, sampler and VQ
decode as ``torch.export`` programs in a zip (``serving/export.py``) and needs
only ``serving.export.load_artifact`` (no model code) to generate:

  python -m spectrogramgenai_tpu_torch.cli.export_model --run.run_name ddpm \\
      --vqae_ckpt models/vqvae --out models/ddpm_sampler.zip --num_labels 27 [--check]

The default sampler is DPM-Solver++(2M) at 20 steps (the serving path); pass
--sampler ddpm for the 999-step chain. ``--platforms cuda,cpu`` writes
programs for both (default: the ``--device`` the model is loaded on, cuda).
JAX StableHLO artifacts are a different format and are not read by the port.
"""

from __future__ import annotations

import argparse
import time


def run(cfg, *, out: str, num_labels: int, sampler: str, num_steps: int, use_ema: bool = False,
        platforms: list[str] | None = None, check: bool = False, device: str = "cuda") -> str:
    import numpy as np

    from spectrogramgenai_tpu_torch.cli.common import load_task, resolve_device
    from spectrogramgenai_tpu_torch.serving.export import export_sampler, load_artifact, save_artifact

    task = load_task(cfg, resolve_device(device), use_ema=use_ema)
    t0 = time.perf_counter()
    blob = export_sampler(task, num_labels=num_labels, use_ema=use_ema, sampler=sampler,
                          num_steps=num_steps, platforms=platforms)
    save_artifact(out, blob)
    print(f"exported {sampler} sampler ({num_labels} labels) → {out} ({len(blob) / 1e6:.1f} MB) "
          f"in {time.perf_counter() - t0:.2f} s")

    if check:
        art = load_artifact(out, device=platforms[0] if platforms else task.device)
        imgs = art(0, np.arange(num_labels) % cfg.num_classes)
        print(f"check: artifact generated {imgs.shape} {imgs.dtype}")
    return out


def main(argv=None):
    from spectrogramgenai_tpu_torch.core.config import DDPMConfig, add_config_args, apply_overrides

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="models/ddpm_sampler.zip")
    p.add_argument("--num_labels", type=int, default=27)
    p.add_argument("--sampler", default="dpmpp", choices=["ddpm", "ddim", "dpmpp"],
                   help="dpmpp = DPM-Solver++(2M), the serving default; ddpm = the 999-step chain")
    p.add_argument("--num_steps", type=int, default=None,
                   help="DDIM/DPM-Solver++ steps (default: 20 for dpmpp, 50 otherwise)")
    p.add_argument("--use_ema", type=int, default=0)
    p.add_argument("--platforms", default=None,
                   help="comma-separated targets, cuda and/or cpu (default: the --device)")
    p.add_argument("--check", action="store_true", help="reload the artifact and generate once")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    add_config_args(p, DDPMConfig)
    a = p.parse_args(argv)
    cfg = apply_overrides(DDPMConfig(), a)
    num_steps = a.num_steps if a.num_steps else (20 if a.sampler == "dpmpp" else 50)
    return run(cfg, out=a.out, num_labels=a.num_labels, sampler=a.sampler, num_steps=num_steps,
               use_ema=bool(a.use_ema), platforms=a.platforms.split(",") if a.platforms else None,
               check=a.check, device=a.device)


if __name__ == "__main__":
    main()
