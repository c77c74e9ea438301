"""Classifier sweep CLI (``spectrogramgenai_tpu/cli/train_classifiers.py``) on one device.

For each model in ``--models`` and each synthetic count in ``--synths``:
the training set plus that many generated images per class (from
``--gen_dir``, named ``{class}_gen_imgs_{i}_{samp}.png``), Adam with the
layer-freeze policy, validation (and ``--test_dir``) after every epoch with
the full metric suite, a per-epoch CSV under
``<output_dir>/<model>_synth<n>/``, and the best-validation-accuracy
checkpoint mirrored to ``<output_dir>/ckpt_<model>_synth<n>/best/``. With
``--embeddings_csv`` (columns ``file_name``, ``embeddings``) the step adds
knowledge distillation against those BirdNET embeddings. Runs on CUDA
unless ``--device`` says otherwise. The JAX CLI's ``--pretrained_dir``
(converted ImageNet weights) and ``--denoiser_ckpt`` are not ported.

  python -m spectrogramgenai_tpu_torch.cli.train_classifiers \\
      --train_dir datasets/train --val_dir datasets/val --test_dir datasets/test \\
      --gen_dir gen_images --models custom,resnet --synths 0,50
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import re
import time

import numpy as np


def evaluate(task, state, src, device, batch_size: int, num_classes: int):
    """A ClassificationMetrics over every image of ``src``."""
    from spectrogramgenai_tpu_torch.data.pipeline import padded_eval_batches
    from spectrogramgenai_tpu_torch.eval.classification import ClassificationMetrics

    metrics = ClassificationMetrics(num_classes)
    for batch, n in padded_eval_batches(src, batch_size, device):
        logits, loss = task.eval_step(state, batch["image"], batch["label"])
        metrics.update(logits[:n].cpu().numpy(), batch["label"][:n].cpu().numpy(), float(loss))
    return metrics


def run_tag(model_name: str, synth: int, knowledge_dist: bool) -> str:
    return f"{model_name}_synth{synth}{'_kd' if knowledge_dist else ''}"


def train_one(model_name: str, synth: int, args, cfg_base, device: str = "cuda") -> float:
    """Train one (model, synthetic count) cell; returns its best validation accuracy."""
    from spectrogramgenai_tpu_torch.cli.common import resolve_device, setup
    from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager
    from spectrogramgenai_tpu_torch.core.metrics import MetricsLogger
    from spectrogramgenai_tpu_torch.data.pipeline import ImageFolderSource, device_prefetch, iterate_batches
    from spectrogramgenai_tpu_torch.train.classifier_task import ClassifierTask

    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg_base, model_name=model_name, synthetic_per_class=synth)
    setup(cfg.run)

    def source(root, **kw):
        return ImageFolderSource(root, img_size=cfg.data.img_size, cache_decoded=cfg.data.cache_decoded,
                                 cache_budget_mb=cfg.data.cache_budget_mb, **kw)

    train_src = source(args.train_dir, seed=cfg.run.seed)
    if synth > 0 and args.gen_dir:
        added = _inject_synthetic(train_src, args.gen_dir, synth, cfg.synthetic_cap, cfg.run.seed)
        print(f"{model_name} synth {synth}: added {added} generated images to {len(train_src.paths) - added} "
              f"real ones", flush=True)
    if getattr(args, "embeddings_csv", None):
        _attach_embeddings(train_src, args.embeddings_csv)
        cfg = dataclasses.replace(cfg, knowledge_dist=True)
    val_src = source(args.val_dir)
    test_src = source(args.test_dir) if args.test_dir else None
    num_classes = len(train_src.classes)
    cfg = dataclasses.replace(cfg, num_classes=num_classes)

    task = ClassifierTask(cfg, dev)
    state = task.init_state()
    tag = run_tag(model_name, synth, cfg.knowledge_dist)
    logger = MetricsLogger(os.path.join(cfg.run.output_dir, tag), csv_name=f"{tag}_metrics.csv",
                           csv_columns=["epoch", "train_loss", "train_acc", "val_acc", "val_f1",
                                        "val_precision", "val_recall", "test_acc", "test_f1"])
    ckpt = CheckpointManager(os.path.join(cfg.run.output_dir, "ckpt_" + tag))

    best_val = -1.0
    for epoch in range(cfg.epochs):
        t0, tl, ta, nb = time.perf_counter(), 0.0, 0.0, 0
        for batch in device_prefetch(iterate_batches(train_src, cfg.data.batch_size, epochs=1), dev):
            state, m = task.train_step(state, batch["image"], batch["label"], batch.get("embedding"))
            tl, ta, nb = tl + m["train_loss"], ta + m["train_acc"], nb + 1  # summed on the device: no sync a step
        tl, ta = float(tl), float(ta)  # waits for the epoch's last step
        wall = time.perf_counter() - t0
        val = evaluate(task, state, val_src, dev, 2 * cfg.data.batch_size, num_classes).compute()
        test = (evaluate(task, state, test_src, dev, 2 * cfg.data.batch_size, num_classes).compute()
                if test_src else {})
        row = {"epoch": epoch, "train_loss": tl / max(1, nb), "train_acc": ta / max(1, nb),
               "val_acc": val["accuracy"], "val_f1": val["f1"], "val_precision": val["precision"],
               "val_recall": val["recall"], "test_acc": test.get("accuracy", ""), "test_f1": test.get("f1", "")}
        logger.log(epoch, **{k: v for k, v in row.items() if v != ""})
        logger.log_csv_row(row)
        if val["accuracy"] > best_val:
            best_val = val["accuracy"]
            ckpt.save(epoch, state.state_dict(), best=True, metric=best_val)
        print(f"{tag} epoch {epoch}: {nb} steps in {wall:.3f} s, {nb * cfg.data.batch_size / wall:.2f} images/s, "
              f"train_loss={row['train_loss']:.4f} val_acc={val['accuracy']:.4f}", flush=True)
    logger.close()
    return best_val


def _attach_embeddings(src, embeddings_csv: str) -> None:
    """Attach each file's BirdNET embedding (CSV columns ``file_name``,
    ``embeddings`` as comma-joined floats) to the source's batches as
    ``"embedding"``; a file without a row gets a zero vector."""
    with open(embeddings_csv, newline="") as f:
        table = {os.path.basename(row["file_name"]): np.asarray([float(v) for v in row["embeddings"].split(",")],
                                                                 np.float32)
                 for row in csv.DictReader(f)}
    dim = len(next(iter(table.values())))
    load_batch = src.load_batch

    def with_embeddings(chunk, num_threads=8):
        out = load_batch(chunk, num_threads=num_threads)
        out["embedding"] = np.stack([table.get(os.path.basename(src.paths[int(i)]), np.zeros(dim, np.float32))
                                     for i in chunk])
        return out

    src.load_batch = with_embeddings


def _inject_synthetic(src, gen_dir: str, per_class: int, cap: int, seed: int) -> int:
    """Append up to ``per_class`` generated PNGs per class (sample index <
    ``cap``), chosen without replacement from ``np.random.default_rng(seed)``,
    to an ImageFolderSource; returns how many were added."""
    rng = np.random.default_rng(seed)
    pattern = re.compile(r"^(.+)_gen_imgs_(\d+)_(\d+)\.png$")
    by_class = {c: [] for c in src.classes}
    for f in sorted(os.listdir(gen_dir)):
        m = pattern.match(f)
        if m and m.group(1) in by_class and int(m.group(3)) < cap:
            by_class[m.group(1)].append(os.path.join(gen_dir, f))
    new_paths, new_labels = [], []
    for ci, cname in enumerate(src.classes):
        files = by_class[cname]
        take = min(per_class, len(files))
        if take:
            new_paths.extend(str(p) for p in rng.choice(np.asarray(files), size=take, replace=False))
            new_labels.extend([ci] * take)
    src.paths = list(src.paths) + new_paths
    src.labels = np.concatenate([src.labels, np.asarray(new_labels, src.labels.dtype)])
    return len(new_paths)


def main(argv=None):
    from spectrogramgenai_tpu_torch.core.config import ClassifierConfig, add_config_args, apply_overrides

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--val_dir", required=True)
    p.add_argument("--test_dir", default=None)
    p.add_argument("--gen_dir", default=None)
    p.add_argument("--models", default="resnet,vgg,mobilenet,custom,ensemble")
    p.add_argument("--synths", default="0,50,100,150,200,250")
    p.add_argument("--embeddings_csv", default=None,
                   help="BirdNET embeddings CSV (file_name, embeddings) → enables knowledge distillation")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    add_config_args(p, ClassifierConfig)
    a = p.parse_args(argv)
    cfg = apply_overrides(ClassifierConfig(), a)

    results = {}
    for model_name in a.models.split(","):
        for synth in (int(s) for s in a.synths.split(",")):
            results[(model_name, synth)] = train_one(model_name, synth, a, cfg, device=a.device)
    for (mn, sy), acc in results.items():
        print(f"{mn} synth={sy}: best val acc {acc:.4f}")
    return results


if __name__ == "__main__":
    main()
