"""Small helpers of the reference (``spectrogramgenai_tpu/utils/misc.py``) in torch and NumPy.

Seeding, a stopwatch, the DCGAN N(0, 0.02) init, one-hot labels and class
planes (NHWC, the port's public layout), a NumPy softmax and accuracy, and
the class proportions and test-set redistribution over manifest rows (lists
of dicts with ``common_name``) instead of pandas frames.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed Python's, NumPy's and torch's global generators; return a CPU
    ``torch.Generator`` seeded with ``seed`` (the JAX function returns its root key)."""
    np.random.seed(seed % (2**32 - 1))
    random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


class Stopwatch:
    """tic/toc wall-clock timing."""

    def __init__(self):
        self._t0 = None

    def tic(self):
        self._t0 = time.time()

    def toc(self, verbose: bool = True) -> float:
        dt = time.time() - (self._t0 or time.time())
        if verbose:
            print(f"Elapsed time: {dt:.6f} seconds.")
        return dt


def dcgan_initializer():
    """The DCGAN init: fill a tensor in place with N(0, 0.02) draws,
    ``init(tensor, generator=None)``, as ``torch.nn.init.normal_``."""

    def init(tensor: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return torch.nn.init.normal_(tensor, 0.0, 0.02, generator=generator)

    return init


def onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot rows, as ``jax.nn.one_hot``."""
    return torch.nn.functional.one_hot(torch.as_tensor(labels, dtype=torch.long), num_classes).float()


def add_class_channels(x: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """NHWC images (b, h, w, c) → (b, h, w, c + num_classes): one constant
    indicator plane per class appended after the channels."""
    b, h, w, _ = x.shape
    planes = onehot(labels, num_classes).to(device=x.device, dtype=x.dtype)[:, None, None, :]
    return torch.cat([x, planes.expand(b, h, w, num_classes)], dim=-1)


def softmax_np(x: np.ndarray, axis: int = -1) -> np.ndarray:
    e = np.exp(x - np.max(x, axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def compute_acc(preds: np.ndarray, labels: np.ndarray) -> float:
    """argmax accuracy."""
    return float(np.mean(np.argmax(preds, axis=-1) == labels))


def prop_counts(rows: list[dict]) -> dict[str, float]:
    """Each class's share of the rows, by class name in sorted order
    (pandas' ``value_counts(normalize=True).sort_index()``)."""
    names = [r["common_name"] for r in rows]
    return {c: names.count(c) / len(names) for c in sorted(set(names))}


def redistribute_datasets(test_rows: list[dict], train_rows: list[dict], val_rows: list[dict],
                          min_test: int = 2) -> tuple[list[dict], list[dict], list[dict]]:
    """Keep at most ``min_test`` rows of each class in test; the surplus of a
    class goes, in turn, to train and to val. Classes in sorted order, rows
    in their order within a class; returns (test, train, val)."""
    by_class: dict[str, list[int]] = {}
    for i, r in enumerate(test_rows):
        by_class.setdefault(r["common_name"], []).append(i)
    to_train, to_val = [], []
    for c in sorted(by_class):
        for j, i in enumerate(by_class[c][min_test:]):
            (to_train if j % 2 == 0 else to_val).append(i)
    moved = set(to_train) | set(to_val)
    return ([r for i, r in enumerate(test_rows) if i not in moved], train_rows + [test_rows[i] for i in to_train],
            val_rows + [test_rows[i] for i in to_val])
