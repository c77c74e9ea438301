"""Structured metrics sink (``spectrogramgenai_tpu/core/metrics.py``): one
JSONL stream (``metrics.jsonl``, one object per ``log`` call with the step,
the seconds since start and the scalars) and an optional CSV with a fixed
column schema. The JAX logger's wandb adapter is not ported:
``log_artifact`` and ``log_images`` return False, and the PNGs and
checkpoints on disk are the record.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Iterable


class MetricsLogger:
    def __init__(self, run_dir: str, csv_name: str | None = None, csv_columns: Iterable[str] | None = None):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a", buffering=1)
        self._csv_path = os.path.join(run_dir, csv_name) if csv_name else None
        self._csv_columns = list(csv_columns) if csv_columns else None
        self._csv_started = self._csv_path is not None and os.path.exists(self._csv_path)
        self._t0 = time.time()

    def log(self, step: int, **scalars):
        record = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        record.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(record) + "\n")

    def log_artifact(self, path: str, name: str = "model", type: str = "model",
                     description: str | None = None, metadata: dict | None = None) -> bool:
        """No artifact store: returns False."""
        return False

    def log_images(self, step: int, images: dict) -> bool:
        """No image panel store: returns False."""
        return False

    def log_csv_row(self, row: dict):
        """Append a row to the run CSV."""
        if self._csv_path is None:
            raise ValueError("MetricsLogger constructed without csv_name")
        columns = self._csv_columns or list(row.keys())
        with open(self._csv_path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=columns, extrasaction="ignore")
            if not self._csv_started:
                writer.writeheader()
            writer.writerow({k: row.get(k, "") for k in columns})
        self._csv_started = True

    def close(self):
        self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
