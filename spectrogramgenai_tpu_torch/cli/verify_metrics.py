"""Score a folder pair in one run: IS, FID and, given audio, FAD (``spectrogramgenai_tpu/cli/verify_metrics.py``).

Reads ``inception_v3.msgpack``, ``clap_audio.msgpack`` and ``manifest.json``
from ``--weights_dir`` (``tools/provision_eval_weights.py``), the flax files
of the JAX package through ``core/flax_msgpack.py``:

  python -m spectrogramgenai_tpu_torch.cli.verify_metrics \\
      --real_dir datasets/val_flat --gen_dir gen_images \\
      --weights_dir models/eval \\
      [--real_audio_dir bg_wavs --gen_audio_dir gen_wavs]

Prints IS(gen_dir) mean ± std, FID(real_dir, gen_dir) and, when audio dirs
and the CLAP tower are there, FAD(real_audio, gen_audio) in CLAP space.
Refuses to score without converted weights unless --allow_random_weights 1.
Runs on ``--device`` (CUDA by default).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def run(real_dir: str, gen_dir: str, weights_dir: str, *,
        real_audio_dir: str | None = None, gen_audio_dir: str | None = None,
        splits: int = 10, limit: int | None = None, sample_rate: int = 48000,
        allow_random_weights: bool = False, device: torch.device | str = "cuda") -> dict:
    from spectrogramgenai_tpu_torch.cli.common import resolve_device
    from spectrogramgenai_tpu_torch.cli.fid import compute_features
    from spectrogramgenai_tpu_torch.cli.inception_score import compute_probs, load_images
    from spectrogramgenai_tpu_torch.eval.inception import (
        frechet_distance,
        gaussian_statistics,
        inception_score,
        load_inception_params,
    )

    device = resolve_device(str(device))
    results: dict = {}

    inception_path = os.path.join(weights_dir, "inception_v3.msgpack")
    params = load_inception_params(inception_path)
    if params is None and not allow_random_weights:
        sys.exit(f"no converted InceptionV3 weights at {inception_path} — run "
                 "tools/provision_eval_weights.py first, or pass "
                 "--allow_random_weights 1 for a pipeline smoke run")
    if params is None:
        print("WARNING: random InceptionV3 weights — IS/FID are NOT meaningful")

    manifest_path = os.path.join(weights_dir, "manifest.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
        inc = manifest.get("inception_v3", {})
        if inc:
            print(f"inception_v3: sha256={inc.get('sha256', '?')[:12]}… "
                  f"verified={inc.get('verified')} "
                  f"max_abs_err={inc.get('max_abs_forward_err')}")

    gen_images = load_images(gen_dir, limit)
    real_images = load_images(real_dir, limit)

    mean, std = inception_score(compute_probs(gen_images, params, device=device), splits=splits)
    results["inception_score_mean"], results["inception_score_std"] = mean, std
    print(f"Inception Score (gen, n={len(gen_images)}): {mean:.4f} ± {std:.4f}")

    mu1, s1 = gaussian_statistics(compute_features(real_images, params, device=device))
    mu2, s2 = gaussian_statistics(compute_features(gen_images, params, device=device))
    results["fid"] = frechet_distance(mu1, s1, mu2, s2)
    print(f"FID (real vs gen, n={len(real_images)}/{len(gen_images)}): {results['fid']:.4f}")

    if real_audio_dir and gen_audio_dir:
        from spectrogramgenai_tpu_torch.eval.fad import embeddings_for_dir, fad_score

        clap_path = os.path.join(weights_dir, "clap_audio.msgpack")
        if not os.path.exists(clap_path):
            sys.exit(f"audio dirs given but no CLAP tower at {clap_path} — "
                     "provision it with tools/provision_eval_weights.py --clap …")
        bg = embeddings_for_dir(real_audio_dir, "clap", sample_rate, clap_ckpt=clap_path, device=device)
        ev = embeddings_for_dir(gen_audio_dir, "clap", sample_rate, clap_ckpt=clap_path, device=device)
        results["fad"] = fad_score(bg, ev)
        print(f"FAD (CLAP): {results['fad']:.6f}")

    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--real_dir", required=True, help="folder of real PNGs")
    p.add_argument("--gen_dir", required=True, help="folder of generated PNGs")
    p.add_argument("--weights_dir", default="models/eval",
                   help="provisioned weights dir (tools/provision_eval_weights.py)")
    p.add_argument("--real_audio_dir", default=None, help="real wavs (FAD)")
    p.add_argument("--gen_audio_dir", default=None, help="generated wavs (FAD)")
    p.add_argument("--splits", type=int, default=10)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--sample_rate", type=int, default=48000)
    p.add_argument("--allow_random_weights", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    a = p.parse_args(argv)
    return run(a.real_dir, a.gen_dir, a.weights_dir,
               real_audio_dir=a.real_audio_dir, gen_audio_dir=a.gen_audio_dir,
               splits=a.splits, limit=a.limit, sample_rate=a.sample_rate,
               allow_random_weights=bool(a.allow_random_weights), device=a.device)


if __name__ == "__main__":
    main()
