"""Inception Score CLI (``spectrogramgenai_tpu/cli/inception_score.py``).

Folder of PNGs → RGB 299×299 → InceptionV3 logits → IS mean ± std (splits
10). :func:`load_images` reads the folder bit-equal to the JAX function
(PIL's ``convert("RGB")`` and BILINEAR resize, here in NumPy). The forward
runs in float32 with TF32 off on ``--device`` (CUDA by default).

Needs converted ImageNet weights (``tools/port_convert_torchvision.py`` →
``--weights``); without them the CLI refuses to print a score unless
``--allow_random_weights 1`` is passed (a pipeline check only: the port's
random init, not the JAX package's, so the two print different scores).

  python -m spectrogramgenai_tpu_torch.cli.inception_score --image_dir gen_images \\
      --weights models/inception_v3.msgpack
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def load_images(image_dir: str, limit: int | None = None) -> np.ndarray:
    """Every PNG/JPEG under ``image_dir`` (recursively: flat folders and
    datasets/{split}/{class}/ trees both work), sorted, as (n, 299, 299, 3)
    uint8 RGB; with ``limit``, a uniform subsample from
    ``np.random.default_rng(0)`` in sorted order. JPEG is not read (there is
    no JPEG decoder here): it raises."""
    from spectrogramgenai_tpu_torch.audio.export import load_image_rgb, pil_resize

    files = sorted(
        os.path.join(root, f)
        for root, _dirs, names in os.walk(image_dir)
        for f in names
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    if limit and len(files) > limit:
        # a sorted-prefix cut would take only the alphabetically first classes of a tree
        keep = np.random.default_rng(0).choice(len(files), size=limit, replace=False)
        files = [files[i] for i in sorted(keep)]
    if not files:
        raise FileNotFoundError(f"no images in {image_dir}")
    out = []
    for f in files:
        if not f.lower().endswith(".png"):
            raise ValueError(f"{f}: only PNG images are read")
        out.append(pil_resize(load_image_rgb(f), (299, 299), "bilinear"))
    return np.stack(out)


def compute_probs(images_u8: np.ndarray, params: dict | None = None, batch: int = 32,
                  device: torch.device | str = "cuda", model=None) -> np.ndarray:
    """(n, H, W, 3) uint8 → (n, 1000) float32 softmax of InceptionV3's logits,
    with the flax ``params`` (or the port's random init when None), or with
    ``model`` (an :func:`eval.inception.build_inception` net) where given.
    The last chunk is not padded: eval-mode BatchNorm makes each row independent."""
    from spectrogramgenai_tpu_torch.cli.common import resolve_device
    from spectrogramgenai_tpu_torch.core.precision import full_float32
    from spectrogramgenai_tpu_torch.eval.inception import build_inception, inception_inputs

    if model is None:
        model = build_inception(params, resolve_device(str(device)))
    device = next(model.parameters()).device
    probs = []
    with torch.no_grad(), full_float32():
        for i in range(0, len(images_u8), batch):
            logits = model(inception_inputs(images_u8[i : i + batch], device))
            probs.append(torch.softmax(logits, dim=-1).cpu().numpy())
    return np.concatenate(probs)


def main(argv=None):
    from spectrogramgenai_tpu_torch.eval.inception import inception_score, load_inception_params

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--splits", type=int, default=10)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--allow_random_weights", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    a = p.parse_args(argv)

    params = load_inception_params(a.weights)
    if params is None and not a.allow_random_weights:
        sys.exit("no converted InceptionV3 weights found; pass --weights (see "
                 "tools/port_convert_torchvision.py) or --allow_random_weights 1 for a smoke run")
    if params is None:
        print("WARNING: random InceptionV3 weights — score is NOT meaningful")

    images = load_images(a.image_dir, a.limit)
    probs = compute_probs(images, params, device=a.device)
    mean, std = inception_score(probs, splits=a.splits)
    print(f"Inception Score: {mean:.4f} ± {std:.4f}  (n={len(images)})")
    return mean, std


if __name__ == "__main__":
    main()
