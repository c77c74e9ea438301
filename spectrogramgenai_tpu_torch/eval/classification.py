"""Classification metrics in NumPy (``spectrogramgenai_tpu/eval/classification.py``).

Macro precision / recall / F1, macro accuracy, top-1/3/5 accuracy (and
their 1 − acc "error" columns), a streaming confusion matrix and a
per-class report. Macro semantics are torchmetrics' defaults: per-class
scores averaged over classes, a class with no support contributing 0 (not
NaN) to the mean. The report is a list of rows (dicts), not a pandas frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def confusion_matrix(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> np.ndarray:
    """(N,) preds, (N,) labels → (num_classes, num_classes) counts; rows = true."""
    idx = np.asarray(labels) * num_classes + np.asarray(preds)
    return np.bincount(idx, minlength=num_classes * num_classes).reshape(num_classes, num_classes)


def _per_class(cm: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    fp, fn = cm.sum(axis=0) - tp, cm.sum(axis=1) - tp
    precision = np.divide(tp, tp + fp, out=np.zeros_like(tp), where=(tp + fp) > 0)
    recall = np.divide(tp, tp + fn, out=np.zeros_like(tp), where=(tp + fn) > 0)
    f1 = np.divide(2 * precision * recall, precision + recall, out=np.zeros_like(tp),
                   where=(precision + recall) > 0)
    return precision, recall, f1


def macro_precision_recall_f1(cm: np.ndarray) -> tuple[float, float, float]:
    """Macro P/R/F1 from a confusion matrix (rows = true class)."""
    precision, recall, f1 = _per_class(cm)
    return float(precision.mean()), float(recall.mean()), float(f1.mean())


def macro_accuracy(cm: np.ndarray) -> float:
    """torchmetrics' multiclass accuracy with macro averaging (= macro recall)."""
    cm = np.asarray(cm, np.float64)
    support = cm.sum(axis=1)
    return float(np.divide(np.diag(cm), support, out=np.zeros(len(cm)), where=support > 0).mean())


def top_k_accuracy(logits: np.ndarray, labels: np.ndarray, k: int) -> float:
    """Micro top-k accuracy over the batch."""
    order = np.argsort(-np.asarray(logits), axis=-1, kind="stable")
    return float((order[:, :k] == np.asarray(labels)[:, None]).any(axis=-1).mean())


@dataclasses.dataclass
class ClassificationMetrics:
    """Streaming accumulator across eval batches."""

    num_classes: int
    cm: np.ndarray = None
    topk_hits: dict = None
    n: int = 0
    loss_sum: float = 0.0
    batches: int = 0

    def __post_init__(self):
        self.cm = np.zeros((self.num_classes, self.num_classes), np.int64)
        self.topk_hits = {1: 0, 3: 0, 5: 0}

    def update(self, logits: np.ndarray, labels: np.ndarray, loss: float | None = None):
        logits, labels = np.asarray(logits), np.asarray(labels)
        np.add.at(self.cm, (labels, logits.argmax(axis=-1)), 1)
        order = np.argsort(-logits, axis=-1)
        for k in self.topk_hits:
            self.topk_hits[k] += int((order[:, :k] == labels[:, None]).any(axis=-1).sum())
        self.n += len(labels)
        if loss is not None:
            self.loss_sum += float(loss)
            self.batches += 1

    def compute(self) -> dict:
        p, r, f1 = macro_precision_recall_f1(self.cm)
        out = {"accuracy": macro_accuracy(self.cm), "precision": p, "recall": r, "f1": f1,
               "micro_accuracy": float(np.trace(self.cm) / max(1, self.n))}
        for k, hits in self.topk_hits.items():
            out[f"top{k}_acc"] = hits / max(1, self.n)
            out[f"top{k}_err"] = 1.0 - out[f"top{k}_acc"]
        if self.batches:
            out["loss"] = self.loss_sum / self.batches
        return out

    def classification_report(self, class_names: list[str]) -> list[dict]:
        """One row per class: ``class``, ``precision``, ``recall``, ``f1-score``, ``support``."""
        precision, recall, f1 = _per_class(self.cm)
        support = self.cm.sum(axis=1)
        return [{"class": name, "precision": float(precision[i]), "recall": float(recall[i]),
                 "f1-score": float(f1[i]), "support": int(support[i])} for i, name in enumerate(class_names)]
