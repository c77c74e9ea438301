"""Image-folder scans, the bootstrap class balance, and the gen_specs detection manifest.

Counterparts of parts of ``spectrogramgenai_tpu/data/manifest.py`` and of the
CSV branch of ``spectrogramgenai_tpu/cli/gen_specs.py``, without pandas.
"""

from __future__ import annotations

import csv
import os

import numpy as np

REQUIRED_COLUMNS = ("file_name", "begin_time", "end_time")


def class_names_from_folder(root: str) -> list[str]:
    """Sorted subdirectory names (ImageFolder convention)."""
    return sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))


def scan_image_folder(root: str) -> tuple[list[str], list[int], list[str]]:
    """ImageFolder scan: (paths, integer labels, class names), sorted as the JAX scan sorts."""
    classes = class_names_from_folder(root)
    paths, labels = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".npy")):
                paths.append(os.path.join(cdir, fname))
                labels.append(ci)
    return paths, labels, classes


def bootstrap_balance_indices(labels: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Class-balanced bootstrap: every class resampled with replacement up to
    the largest class's size (the same draws as the JAX function for one rng)."""
    labels = np.asarray(labels)
    classes, counts = np.unique(labels, return_counts=True)
    max_size = counts.max()
    out = []
    for c in classes:
        idx = np.nonzero(labels == c)[0]
        out.extend(rng.choice(idx, size=max_size, replace=True))
    return np.asarray(out)


def read_detection_manifest(path: str, limit: int | None = None) -> list[dict]:
    """Rows of a detection CSV (``file_name, begin_time, end_time, common_name``,
    other columns kept as text) in file order, the first ``limit`` if given.
    ``begin_time`` and ``end_time`` are parsed as floats."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        missing = [c for c in REQUIRED_COLUMNS if c not in (reader.fieldnames or ())]
        if missing:
            raise ValueError(f"{path}: manifest lacks column(s) {missing}")
        rows = []
        for row in reader:
            if limit and len(rows) >= limit:
                break
            row["begin_time"], row["end_time"] = float(row["begin_time"]), float(row["end_time"])
            rows.append(row)
    return rows
