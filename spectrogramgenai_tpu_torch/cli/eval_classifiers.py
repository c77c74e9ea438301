"""Best-classifier evaluation (``spectrogramgenai_tpu/cli/eval_classifiers.py``) on one device.

Reloads each (model × synthetic count) best-validation checkpoint that
``cli.train_classifiers`` wrote, evaluates it on ``--val_dir`` (and
``--test_dir``) with the full metric suite, and writes
``<out_dir>/eval_results.csv`` (one row per checkpoint) and, with a test
set, ``<out_dir>/<tag>_classification_report.csv`` (one row per class). The
JAX CLI's confusion-matrix figure is not ported. Runs on CUDA unless
``--device`` says otherwise.

  python -m spectrogramgenai_tpu_torch.cli.eval_classifiers --val_dir datasets/val \\
      --test_dir datasets/test --models custom,resnet --synths 0,50
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os


def eval_one(model_name: str, synth: int, args, cfg_base, device: str = "cuda") -> dict | None:
    """The metrics row of one checkpoint, or None if it has no best checkpoint."""
    from spectrogramgenai_tpu_torch.cli.common import resolve_device
    from spectrogramgenai_tpu_torch.cli.train_classifiers import evaluate, run_tag
    from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager
    from spectrogramgenai_tpu_torch.data.pipeline import ImageFolderSource
    from spectrogramgenai_tpu_torch.train.classifier_task import ClassifierTask

    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg_base, model_name=model_name, synthetic_per_class=synth)

    def source(root):
        return ImageFolderSource(root, img_size=cfg.data.img_size, cache_decoded=cfg.data.cache_decoded,
                                 cache_budget_mb=cfg.data.cache_budget_mb)

    val_src = source(args.val_dir)
    test_src = source(args.test_dir) if args.test_dir else None
    num_classes = len(val_src.classes)
    cfg = dataclasses.replace(cfg, num_classes=num_classes)

    tag = run_tag(model_name, synth, cfg.knowledge_dist)
    saved = CheckpointManager(os.path.join(cfg.run.output_dir, "ckpt_" + tag)).restore(best=True)
    if saved is None:
        print(f"skip {tag}: no best checkpoint")
        return None
    task = ClassifierTask(cfg, dev)
    state = task.load_state(task.init_state(), saved)

    out = {"model": model_name, "synth": synth}
    val_m = evaluate(task, state, val_src, dev, 2 * cfg.data.batch_size, num_classes)
    out.update({f"val_{k}": v for k, v in val_m.compute().items()})
    if test_src is not None:
        test_m = evaluate(task, state, test_src, dev, 2 * cfg.data.batch_size, num_classes)
        out.update({f"test_{k}": v for k, v in test_m.compute().items()})
        write_rows(os.path.join(args.out_dir, f"{tag}_classification_report.csv"),
                   test_m.classification_report(val_src.classes))
    return out


def write_rows(path: str, rows: list[dict]) -> None:
    """``rows`` as a CSV with a header of every key, in first-seen order."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    columns = list(dict.fromkeys(k for row in rows for k in row))
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=columns)
        writer.writeheader()
        writer.writerows(rows)


def main(argv=None):
    from spectrogramgenai_tpu_torch.core.config import ClassifierConfig, add_config_args, apply_overrides

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--val_dir", required=True)
    p.add_argument("--test_dir", default=None)
    p.add_argument("--out_dir", default="results/eval")
    p.add_argument("--models", default="resnet,vgg,mobilenet,custom,ensemble")
    p.add_argument("--synths", default="0,50,100,150,200,250")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    add_config_args(p, ClassifierConfig)
    a = p.parse_args(argv)
    cfg = apply_overrides(ClassifierConfig(), a)

    rows = []
    for model_name in a.models.split(","):
        for synth in (int(s) for s in a.synths.split(",")):
            row = eval_one(model_name, synth, a, cfg, device=a.device)
            if row:
                rows.append(row)
    write_rows(os.path.join(a.out_dir, "eval_results.csv"), rows)
    print(f"wrote {len(rows)} rows to {a.out_dir}/eval_results.csv")
    return rows


if __name__ == "__main__":
    main()
