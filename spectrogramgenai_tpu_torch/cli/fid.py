"""FID CLI (``spectrogramgenai_tpu/cli/fid.py``).

The Fréchet distance between two image folders, loaded as 299×299 RGB
(``cli.inception_score.load_images``), in one of two feature spaces:

  * InceptionV3's 2048-d pool features (pytorch-fid's patched branch pools,
    the reference's FID recipe), float32 with TF32 off, with converted
    ImageNet weights (``--weights``; ``--allow_random_weights 1`` runs the
    port's random init as a pipeline check);
  * with ``--classifier_ckpt``, the logit space of a trained project
    classifier (``cli.train_classifiers``' best checkpoint), a
    domain-relevant FID without ImageNet weights: the images go to
    grayscale and back to 256×256 (PIL's default BICUBIC filter) as the JAX
    CLI feeds its classifier, and the forward runs in ``--compute_dtype``
    (bfloat16, the config's default, as in JAX).

Both run on ``--device`` (CUDA by default).

  python -m spectrogramgenai_tpu_torch.cli.fid --dir1 real_images --dir2 gen_images \\
      --weights models/inception_v3.msgpack
  python -m spectrogramgenai_tpu_torch.cli.fid --dir1 datasets/val --dir2 gen_images \\
      --classifier_ckpt results/ckpt_custom_synth0 --limit 540
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def compute_features(images_u8: np.ndarray, params: dict | None = None, batch: int = 32,
                     device: torch.device | str = "cuda", model=None) -> np.ndarray:
    """(n, H, W, 3) uint8 → (n, 2048) float32 InceptionV3 pool features with
    pytorch-fid's branch pools, from the flax ``params`` (or the port's
    random init when None), or from ``model`` (an
    ``eval.inception.build_inception(…, fid_pool=True)`` net) where given."""
    from spectrogramgenai_tpu_torch.cli.common import resolve_device
    from spectrogramgenai_tpu_torch.core.precision import full_float32
    from spectrogramgenai_tpu_torch.eval.inception import build_inception, inception_inputs

    if model is None:
        model = build_inception(params, resolve_device(str(device)), fid_pool=True)
    device = next(model.parameters()).device
    feats = []
    with torch.no_grad(), full_float32():
        for i in range(0, len(images_u8), batch):
            feats.append(model(inception_inputs(images_u8[i : i + batch], device), return_features=True).cpu().numpy())
    return np.concatenate(feats)


def load_classifier(ckpt_dir: str, model_name: str = "custom", num_classes: int = 27,
                    compute_dtype: str = "bfloat16", device: str = "cuda"):
    """(ClassifierTask, TrainState) with the weights of ``ckpt_dir``'s best
    checkpoint, or its latest when it has no best one."""
    from spectrogramgenai_tpu_torch.cli.common import resolve_device
    from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager
    from spectrogramgenai_tpu_torch.core.config import ClassifierConfig
    from spectrogramgenai_tpu_torch.train.classifier_task import ClassifierTask

    cfg = ClassifierConfig(model_name=model_name, num_classes=num_classes, compute_dtype=compute_dtype)
    task = ClassifierTask(cfg, resolve_device(device))
    ckpt = CheckpointManager(ckpt_dir)
    saved = ckpt.restore(best=True)
    if saved is None:
        saved = ckpt.restore()
    if saved is None:
        raise FileNotFoundError(f"no classifier checkpoint under {ckpt_dir}")
    return task, task.init_state(variables=saved["params"])


def classifier_inputs(images_u8: np.ndarray) -> np.ndarray:
    """(n, H, W, 3) uint8 RGB → (n, 256, 256, 1) float32 in [0, 1]: PIL's
    ``convert("L")`` and ``resize((256, 256))`` (BICUBIC), then / 255."""
    from spectrogramgenai_tpu_torch.audio.export import _rgb_to_l, pil_resize

    return np.stack([pil_resize(_rgb_to_l(c), (256, 256), "bicubic").astype(np.float32) / 255.0
                     for c in images_u8])[..., None]


def classifier_features(images_u8: np.ndarray, args=None, batch: int = 32, classifier=None) -> np.ndarray:
    """(n, num_classes) float32 logits of a project classifier: ``classifier``
    as :func:`load_classifier` returns it, or loaded from ``args``
    (``classifier_ckpt``, ``classifier_model``, ``num_classes`` and, if
    given, ``compute_dtype`` and ``device``)."""
    if classifier is None:
        classifier = load_classifier(args.classifier_ckpt, args.classifier_model, args.num_classes,
                                     getattr(args, "compute_dtype", "bfloat16"), getattr(args, "device", "cuda"))
    task, state = classifier
    feats = []
    for i in range(0, len(images_u8), batch):
        x = torch.from_numpy(classifier_inputs(images_u8[i : i + batch])).to(task.device)
        logits, _ = task.eval_step(state, x, torch.zeros(len(x), dtype=torch.long, device=task.device))
        feats.append(logits.cpu().numpy())
    return np.concatenate(feats)


def main(argv=None):
    from spectrogramgenai_tpu_torch.cli.common import resolve_device
    from spectrogramgenai_tpu_torch.cli.inception_score import load_images
    from spectrogramgenai_tpu_torch.eval.inception import (
        build_inception,
        frechet_distance,
        gaussian_statistics,
        load_inception_params,
    )

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dir1", required=True)
    p.add_argument("--dir2", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--classifier_ckpt", default=None,
                   help="a trained project classifier (cli.train_classifiers best ckpt) as the feature extractor")
    p.add_argument("--classifier_model", default="custom")
    p.add_argument("--num_classes", type=int, default=27)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--allow_random_weights", type=int, default=0)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    a = p.parse_args(argv)

    if a.classifier_ckpt:
        classifier = load_classifier(a.classifier_ckpt, a.classifier_model, a.num_classes, a.compute_dtype,
                                     a.device)
        f1 = classifier_features(load_images(a.dir1, a.limit), classifier=classifier)
        f2 = classifier_features(load_images(a.dir2, a.limit), classifier=classifier)
        mu1, s1 = gaussian_statistics(f1)
        mu2, s2 = gaussian_statistics(f2)
        print(f"FID (classifier '{a.classifier_model}' logits space): "
              f"{frechet_distance(mu1, s1, mu2, s2):.4f}  (n1={len(f1)}, n2={len(f2)})")
        return

    params = load_inception_params(a.weights)
    if params is None and not a.allow_random_weights:
        sys.exit("no converted InceptionV3 weights; pass --weights (tools/convert_torchvision.py), "
                 "--classifier_ckpt for a domain classifier feature space, "
                 "or --allow_random_weights 1 for a smoke run")
    if params is None:
        print("WARNING: random InceptionV3 weights — FID is NOT meaningful")

    model = build_inception(params, resolve_device(a.device), fid_pool=True)
    f1 = compute_features(load_images(a.dir1, a.limit), model=model)
    f2 = compute_features(load_images(a.dir2, a.limit), model=model)
    mu1, s1 = gaussian_statistics(f1)
    mu2, s2 = gaussian_statistics(f2)
    print(f"FID: {frechet_distance(mu1, s1, mu2, s2):.4f}  (n1={len(f1)}, n2={len(f2)})")


if __name__ == "__main__":
    main()
