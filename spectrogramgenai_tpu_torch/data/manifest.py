"""Image-folder scans, the bootstrap class balance, the gen_specs detection
manifest, the ``specdata.npz`` splits, the Neal test filter, and the few
pandas operations their callers need: CSV reading with pandas' column types
and float parser, and an inner merge.

Counterparts of ``spectrogramgenai_tpu/data/manifest.py`` and of the
manifest branches of ``spectrogramgenai_tpu/cli/gen_specs.py``, without
pandas: a table is a list of rows, each a dict from column name to value.
"""

from __future__ import annotations

import csv
import math
import os
import re

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
    """Rows of a detection manifest (``file_name, begin_time, end_time,
    common_name``, other columns kept) in file order, the first ``limit`` if
    given. A CSV keeps its other columns as text; a ``specdata.npz`` gives its
    ``train_df`` split with the columns :func:`load_specdata_manifest` gives
    it (the JAX CLI's ``.npz`` branch builds a frame with the columns 0 … k−1
    and then fails on ``row["file_name"]``). ``begin_time`` and ``end_time``
    are parsed as floats."""
    if path.endswith(".npz"):
        table, _, _ = load_specdata_manifest(path)
        columns = list(table[0]) if table else []
    else:
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            columns, table = list(reader.fieldnames or ()), list(reader)
    missing = [c for c in REQUIRED_COLUMNS if c not in columns]
    if missing:
        raise ValueError(f"{path}: manifest lacks column(s) {missing}")
    rows = table[:limit] if limit else table
    for row in rows:
        row["begin_time"], row["end_time"] = float(row["begin_time"]), float(row["end_time"])
    return rows


def load_specdata_manifest(path: str, columns: list[str] | None = None) -> tuple[list[dict], list[dict], list[str]]:
    """The reference's ``specdata.npz`` → (train rows, test rows, class names).

    The column names are ``columns``, else the file's own ``columns`` array,
    else ``col0`` … ``col{k−1}``; values are the object arrays' elements."""
    with np.load(path, allow_pickle=True) as data:
        cats = [str(c) for c in data["categories"]]
        if columns is None and "columns" in data:
            columns = [str(c) for c in data["columns"]]
        train, test = data["train_df"], data["test_df"]
    if columns is None:
        columns = [f"col{i}" for i in range(train.shape[1])]
    for split in (train, test):
        if split.ndim != 2 or split.shape[1] != len(columns):
            raise ValueError(f"{path}: a split of shape {split.shape} for {len(columns)} columns")

    def table(split):
        return [dict(zip(columns, row)) for row in split.tolist()]

    return table(train), table(test), cats


_NA = ("", "nan", "NaN", "NA", "N/A", "NULL", "null", "None", "<NA>", "-nan", "-NaN")
_INT = re.compile(r"^\s*[+-]?\d+\s*$")
_FLOAT = re.compile(r"^\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?\s*$")


def read_csv_table(path: str) -> tuple[list[str], list[dict]]:
    """A CSV → (columns, rows) with pandas' default column types: a column of
    integers is int, a column of numbers (or missing values) float, parsed
    as pandas parses them (:func:`pandas_float`), anything else text, with
    a missing value (an empty cell, ``NA`` …) as NaN."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        columns = next(reader, [])
        body = [r for r in reader if r]
    values = []
    for j in range(len(columns)):
        cells = [r[j] if j < len(r) else "" for r in body]
        if all(_INT.match(c) for c in cells):
            values.append([int(c) for c in cells])
        elif all(_FLOAT.match(c) or c.strip() in _NA for c in cells):
            values.append([pandas_float(c) for c in cells])
        else:
            values.append([math.nan if c.strip() in _NA else c for c in cells])
    return columns, [dict(zip(columns, row)) for row in zip(*values)]


def inner_merge(left: list[dict], right: list[dict], left_on: list[str], right_on: list[str]) -> list[dict]:
    """pandas' ``left.merge(right, left_on=…, right_on=…)`` (an inner join):
    for each left row in order, one output row per matching right row, in
    right order (duplicate keys give every pair). A key column of one name on
    both sides is kept once, the left's; other columns both sides have get
    pandas' suffixes ``_x`` and ``_y``."""
    matches: dict[tuple, list[dict]] = {}
    for r in right:
        matches.setdefault(tuple(r[c] for c in right_on), []).append(r)
    shared = {a for a, b in zip(left_on, right_on) if a == b}
    left_cols = list(left[0]) if left else []
    right_cols = [c for c in (right[0] if right else ()) if c not in shared]
    clash = set(left_cols) & set(right_cols)
    out = []
    for lrow in left:
        for rrow in matches.get(tuple(lrow[c] for c in left_on), ()):
            row = {(c + "_x" if c in clash else c): lrow[c] for c in left_cols}
            row.update({(c + "_y" if c in clash else c): rrow[c] for c in right_cols})
            out.append(row)
    return out


def zscore_columns(rows: list[dict], columns: list[str]) -> None:
    """Each of ``columns`` in place → (x − mean) / std(ddof=0), in float64, as
    pandas' ``(df[c] - df[c].mean()) / df[c].std(ddof=0)``."""
    for c in columns:
        x = np.asarray([r[c] for r in rows], np.float64)
        mean = x.sum() / len(x)
        std = np.sqrt(((mean - x) ** 2).sum() / len(x))
        for r, v in zip(rows, (x - mean) / std):
            r[c] = float(v)


def neal_test_filter(rows: list[dict], classes: list[str], image_dir: str,
                     labelers=("dk", "hh", "iw", "ms"), min_confidence: float = 0.9) -> list[dict]:
    """The reference's Neal test-set filter over rows with ``class_label``,
    ``start_time``, ``confidence``, ``labeler`` and ``file_name``: trusted
    labelers, confidence ≥ ``min_confidence``, the class among ``classes``,
    the first row of each (file, whole begin second), and the exported PNG
    ``{file}_{begin}_{begin}.png`` present in ``image_dir``. New rows, with
    ``common_name``, ``begin_time`` (int) and ``formatted_file`` set."""
    available = set(os.listdir(image_dir)) if os.path.isdir(image_dir) else set()
    seen, out = set(), []
    for row in rows:
        row = {**row, "common_name": row["class_label"], "begin_time": int(row["start_time"])}
        if not (row["confidence"] >= min_confidence and row["labeler"] in labelers
                and row["common_name"] in classes):
            continue
        key = (row["file_name"], row["begin_time"])
        if key in seen:
            continue
        seen.add(key)
        row["formatted_file"] = f"{row['file_name']}_{row['begin_time']}_{row['begin_time']}.png"
        if row["formatted_file"] in available:
            out.append(row)
    return out


_POW10 = [float(f"1e{k}") for k in range(309)]


def pandas_float(text: str) -> float:
    """A decimal string as pandas' default C reader parses it (its
    ``precise_xstrtod``): up to 17 digits accumulated as a double, leading
    zeros counted, the rest dropped, then scaled by a power of ten. It can
    differ from ``float(text)`` in the last bits."""
    s = text.strip()
    if s in _NA:
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
