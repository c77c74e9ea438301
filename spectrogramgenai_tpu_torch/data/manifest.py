"""Image-folder scans, the bootstrap class balance, the gen_specs detection
manifest, and pandas' float parser.

Counterparts of parts of ``spectrogramgenai_tpu/data/manifest.py`` and of the
CSV branch of ``spectrogramgenai_tpu/cli/gen_specs.py``, without pandas.
"""

from __future__ import annotations

import csv
import math
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


_POW10 = [float(f"1e{k}") for k in range(309)]


def pandas_float(text: str) -> float:
    """A decimal string as pandas' default C reader parses it (its
    ``precise_xstrtod``): up to 17 digits accumulated as a double, leading
    zeros counted, the rest dropped, then scaled by a power of ten. It can
    differ from ``float(text)`` in the last bits."""
    s = text.strip()
    if s in ("", "nan", "NaN", "NA", "N/A", "NULL", "null", "None", "<NA>", "-nan", "-NaN"):
        return math.nan
    pos, negative = 0, False
    if s[:1] in "+-":
        negative, pos = s[0] == "-", 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while pos < len(s) and s[pos].isdigit():
        if digits < 17:
            number = number * 10.0 + (ord(s[pos]) - 48)
            digits += 1
        else:
            exponent += 1
        pos += 1
    if pos < len(s) and s[pos] == ".":
        pos += 1
        while digits < 17 and pos < len(s) and s[pos].isdigit():
            number = number * 10.0 + (ord(s[pos]) - 48)
            digits += 1
            decimals += 1
            pos += 1
        while pos < len(s) and s[pos].isdigit():
            pos += 1
        exponent -= decimals
    if digits == 0:
        return float(s)  # inf and the like: not written by the sweep
    if negative:
        number = -number
    if pos < len(s) and s[pos] in "eE":
        pos += 1
        sign = 1
        if pos < len(s) and s[pos] in "+-":
            sign, pos = (-1 if s[pos] == "-" else 1), pos + 1
        n = 0
        while pos < len(s) and s[pos].isdigit():
            n, pos = n * 10 + ord(s[pos]) - 48, pos + 1
        exponent += sign * n
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]
