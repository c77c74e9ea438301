"""Cross-run results aggregation of the classifier sweep, without pandas.

The port's counterpart of ``postprocessing/analyse_results.py``: reads each
run's ``<results_dir>/*/<model>_synth<n>[_kd]_metrics.csv`` (written by
``cli.train_classifiers``), takes its best-validation epoch (the first on a
tie), and writes ``aggregate_results.csv`` (model, synth, kd, best epoch,
val/test metrics) and ``results_table.tex`` (best val accuracy per model ×
synthetic count, the mean where the KD and plain runs share a cell). Both
files are byte-equal to the original's: numbers are read as pandas' C parser
reads them (17 significant digits, leading zeros counted, then a division by
a power of ten) and written in its shortest form.

The accuracy-vs-synthetic plot needs matplotlib, which this script does not
use: run ``python postprocessing/analyse_results.py --results_dir results
--out_dir results/analysis`` on a host that has pandas and matplotlib (it
imports no JAX) for the figure, from the same results/.

  python tools/port_analyse_results.py --results_dir results --out_dir results/analysis
"""

from __future__ import annotations

import argparse
import csv
import glob
import math
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spectrogramgenai_tpu_torch.data.manifest import pandas_float  # noqa: E402


def _cell(row: dict, key: str) -> float:
    v = row.get(key)
    return math.nan if v is None else pandas_float(v)


def collect(results_dir: str) -> list[dict]:
    """One row per run, sorted by (model, synth), runs in glob order within a cell."""
    rows = []
    for path in glob.glob(os.path.join(results_dir, "*", "*_metrics.csv")):
        m = re.match(r"^(\w+?)_synth(\d+)(_kd)?_metrics\.csv$", os.path.basename(path))
        if not m:
            continue
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            table = list(reader)
            columns = reader.fieldnames or []
        if "val_acc" not in columns or not table:
            continue
        vals = [_cell(r, "val_acc") for r in table]
        finite = [i for i, v in enumerate(vals) if not math.isnan(v)]
        best = table[max(finite, key=lambda i: (vals[i], -i))]
        rows.append({
            "model": m.group(1),
            "synth": int(m.group(2)),
            "kd": bool(m.group(3)),
            "best_epoch": int(pandas_float(best["epoch"])),
            "val_acc": _cell(best, "val_acc"),
            "val_f1": _cell(best, "val_f1"),
            "test_acc": _cell(best, "test_acc"),
        })
    return sorted(rows, key=lambda r: (r["model"], r["synth"]))


def _fmt(v) -> str:
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(v)
    return str(v)


def write_csv(rows: list[dict], path: str) -> None:
    columns = ["model", "synth", "kd", "best_epoch", "val_acc", "val_f1", "test_acc"]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for r in rows:
            writer.writerow([_fmt(r[c]) for c in columns])


def _mean(values: list[float]) -> float:
    """pandas' grouped mean: a Kahan-compensated sum over the non-NaN values, then / count."""
    total = comp = 0.0
    n = 0
    for v in values:
        if math.isnan(v):
            continue
        n += 1
        y = v - comp
        t = total + y
        comp = t - total - y
        total = t
    return total / n if n else math.nan


def latex_table(rows: list[dict]) -> str:
    models = sorted({r["model"] for r in rows})
    synths = sorted({r["synth"] for r in rows})
    lines = ["\\begin{tabular}{l" + "r" * len(synths) + "}", "\\toprule",
             "model & " + " & ".join(str(c) for c in synths) + " \\\\", "\\midrule"]
    for model in models:
        cells = []
        for synth in synths:
            v = _mean([r["val_acc"] for r in rows if r["model"] == model and r["synth"] == synth])
            cells.append("-" if math.isnan(v) else f"{v:.3f}")
        lines.append(f"{model} & {' & '.join(cells)} \\\\")
    lines += ["\\bottomrule", "\\end{tabular}"]
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--results_dir", default="results")
    p.add_argument("--out_dir", default="results/analysis")
    a = p.parse_args(argv)

    rows = collect(a.results_dir)
    os.makedirs(a.out_dir, exist_ok=True)
    write_csv(rows, os.path.join(a.out_dir, "aggregate_results.csv"))
    if rows:
        with open(os.path.join(a.out_dir, "results_table.tex"), "w") as f:
            f.write(latex_table(rows))
    print(f"aggregated {len(rows)} runs → {a.out_dir}")


if __name__ == "__main__":
    main()
