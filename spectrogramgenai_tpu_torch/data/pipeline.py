"""Host input pipeline for one device: decode → batch → prefetch onto the card.

Counterpart of the image-folder half of ``spectrogramgenai_tpu/data/pipeline.py``:

  * ``ImageFolderSource`` — class-subdirectory PNG tree with optional
    bootstrap class balancing. Its index stream is the JAX source's, element
    for element (``np.random.default_rng(seed)``, the bootstrap, the
    shuffle), and it keeps the bounded decoded-image cache.
  * ``iterate_batches`` — host NumPy batches, with ``skip_batches`` for exact
    mid-epoch resume.
  * ``device_prefetch`` — pinned host memory and a copy on a side CUDA
    stream, overlapped with the step; the consumer's stream waits on an event.
  * ``padded_eval_batches`` — evaluation batches that keep the remainder.

PNGs are decoded by ``audio/export.py``'s NumPy reader in a thread pool
(``zlib`` releases the GIL). The JAX source's bilinear resize of an image of
another size (PIL) is not ported: such an image raises. There is no
multi-host sharding.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
import warnings
from typing import Iterator

import numpy as np
import torch

from spectrogramgenai_tpu_torch.audio.export import image_hw, load_image_grayscale
from spectrogramgenai_tpu_torch.data.manifest import bootstrap_balance_indices, scan_image_folder


def decode_gray_batch(paths: list[str], height: int, width: int, num_threads: int = 8) -> np.ndarray:
    """Grayscale decode of ``paths`` → float32 (n, height, width) in [0, 1]."""
    out = np.zeros((len(paths), height, width), np.float32)

    def one(i: int) -> None:
        img = load_image_grayscale(paths[i])
        if img.shape != (height, width):
            raise ValueError(f"{paths[i]}: image is {img.shape[0]}×{img.shape[1]}, expected "
                             f"{height}×{width} (resizing is not ported)")
        out[i] = img

    with cf.ThreadPoolExecutor(max_workers=max(1, num_threads)) as pool:
        list(pool.map(one, range(len(paths))))
    return out


class _DecodedCache:
    """Bounded in-RAM cache of decoded images, keyed by dataset index: each
    image is decoded on first touch and served from RAM after. If the whole
    dataset would exceed ``budget_mb`` the cache turns itself off with one
    warning."""

    def _cache_init(self, enabled: bool, budget_mb: int):
        self._cache_enabled = enabled
        self._cache_budget = int(budget_mb) << 20
        self._cache_imgs: np.ndarray | None = None
        self._cache_have: np.ndarray | None = None

    def _cache_fetch(self, n: int, chunk: np.ndarray, h: int, w: int, decode_fn):
        """decode_fn(indices) -> (m, h, w) float32 for exactly those rows."""
        chunk = np.asarray(chunk)
        if not self._cache_enabled:
            return decode_fn(chunk)
        if self._cache_imgs is None:
            need = n * h * w * 4
            if need > self._cache_budget:
                warnings.warn(f"decoded-image cache disabled: {n} images at {h}x{w} need {need >> 20} MB > "
                              f"budget {self._cache_budget >> 20} MB (raise data.cache_budget_mb to re-enable)",
                              stacklevel=2)
                self._cache_enabled = False
                return decode_fn(chunk)
            self._cache_imgs = np.zeros((n, h, w), np.float32)
            self._cache_have = np.zeros(n, bool)
        missing = np.unique(chunk[~self._cache_have[chunk]])
        if len(missing):
            self._cache_imgs[missing] = decode_fn(missing)
            self._cache_have[missing] = True
        return self._cache_imgs[chunk]


class ImageFolderSource(_DecodedCache):
    def __init__(self, root: str, bootstrap_balance: bool = False, seed: int = 0,
                 img_size: int | None = None, cache_decoded: bool = False, cache_budget_mb: int = 8192):
        self.paths, self.labels, self.classes = scan_image_folder(root)
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")
        self.labels = np.asarray(self.labels)
        self.bootstrap_balance = bootstrap_balance
        self.rng = np.random.default_rng(seed)
        self.img_size = img_size
        self._probed_hw: tuple[int, int] | None = None
        self._cache_init(cache_decoded, cache_budget_mb)

    def epoch_indices(self) -> np.ndarray:
        """One epoch's sample order (advances the source's rng, as the JAX source does)."""
        if self.bootstrap_balance:
            idx = bootstrap_balance_indices(self.labels, self.rng)
        else:
            idx = np.arange(len(self.paths))
        self.rng.shuffle(idx)
        return idx

    def epoch_size(self) -> int:
        """The length of :meth:`epoch_indices`, without drawing one."""
        if self.bootstrap_balance:
            return len(np.unique(self.labels)) * int(np.bincount(self.labels).max())
        return len(self.paths)

    def _target_hw(self) -> tuple[int, int]:
        if self.img_size:
            return self.img_size, self.img_size
        if self._probed_hw is None:
            self._probed_hw = image_hw(self.paths[0])
        return self._probed_hw

    def load_batch(self, chunk: np.ndarray, num_threads: int = 8) -> dict:
        """{"image": (n, H, W, 1) float32, "label": (n,) int32} for the indices in ``chunk``."""
        h, w = self._target_hw()
        imgs = self._cache_fetch(len(self.paths), chunk, h, w,
                                 lambda idx: decode_gray_batch([self.paths[i] for i in idx], h, w, num_threads))
        return {"image": imgs[..., None], "label": self.labels[chunk].astype(np.int32)}


def iterate_batches(source, batch_size: int, *, drop_remainder: bool = True, num_threads: int = 8,
                    epochs: int | None = 1, skip_batches: int = 0) -> Iterator[dict]:
    """Host NumPy batches of ``source`` (``load_batch`` per batch).

    ``skip_batches`` is exact mid-epoch resume: the first N batches of the
    stream are skipped without decoding, but ``source.epoch_indices()`` is
    still drawn, so a restarted run (same source seed) sees the remaining
    stream the first run would have seen.
    """
    epoch, to_skip = 0, skip_batches
    while epochs is None or epoch < epochs:
        idx = source.epoch_indices()
        usable = len(idx) - (len(idx) % batch_size) if drop_remainder else len(idx)
        for start in range(0, usable, batch_size):
            if to_skip > 0:
                to_skip -= 1
                continue
            yield source.load_batch(idx[start:start + batch_size], num_threads=num_threads)
        epoch += 1


def to_device(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def device_prefetch(batch_iter: Iterator[dict], device: torch.device, depth: int = 2
                    ) -> Iterator[dict[str, torch.Tensor]]:
    """Batches on ``device``, up to ``depth`` ahead of the consumer.

    On a card a producer thread decodes, copies each batch into pinned host
    memory and issues the host→device copy on a side stream, recording an
    event after it; the consumer's current stream waits on that event (on the
    device: the host does not block on it), and each tensor is marked as used
    by the consumer's stream so that the allocator keeps it until then. On the
    CPU the batches are converted in line. A producer error is raised in the
    consumer.
    """
    if device.type != "cuda":
        for batch in batch_iter:
            yield to_device(batch, device)
        return

    copy_stream = torch.cuda.Stream(device)
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()

    def producer():
        try:
            with torch.cuda.stream(copy_stream):
                for batch in batch_iter:
                    dev = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(device, non_blocking=True)
                           for k, v in batch.items()}
                    ready = torch.cuda.Event()
                    ready.record(copy_stream)
                    q.put((dev, ready))
                    if stop.is_set():
                        return
            q.put(sentinel)
        except BaseException as e:  # surfaced in the consumer, never swallowed
            q.put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            dev, ready = item
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(ready)
            for t in dev.values():
                t.record_stream(consumer)
            yield dev
    finally:
        # the consumer stopped early: free the queue, so that a producer
        # blocked on a full one puts its batch, sees ``stop`` and ends
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join()


def padded_eval_batches(source, batch_size: int, device: torch.device):
    """Evaluation batches on ``device`` that keep the remainder, as
    ``(batch, n_true)``. On one device no padding is needed, so n_true is the
    batch's own size."""
    for batch in iterate_batches(source, batch_size, epochs=1, drop_remainder=False):
        yield to_device(batch, device), len(batch["label"])
