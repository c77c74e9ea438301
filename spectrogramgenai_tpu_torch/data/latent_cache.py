"""Latent caching: pre-encode the dataset once through the frozen VQ encoder
(``spectrogramgenai_tpu/data/latent_cache.py``).

The encoder never updates and the input pipeline has no random augmentation,
so a sample's latent is a pure function of its image: ``LatentCacheSource``
encodes every sample once, keeps the latents in host RAM (float32, 64 KB per
256×256 image) and serves ``{"latent", "label"}`` batches with no PNG decode
and no encode in the step. ``epoch_indices`` is the wrapped source's, so the
shuffle and bootstrap stream, the batch order and mid-epoch resume are those
of an uncached run.
"""

from __future__ import annotations

import numpy as np
import torch


class LatentCacheSource:
    def __init__(self, source, encode_fn, device: torch.device, encode_batch: int = 64, num_threads: int = 8):
        """``source``: an ImageFolderSource (``paths``) or DataFrameImageSource
        (``rows``), anything with ``load_batch`` and ``epoch_indices``;
        ``encode_fn``: images (n, H, W, 1) in [0, 1] on ``device`` → latents
        (``DiffusionTask.make_encoder()``)."""
        self.source = source
        n = len(source.paths) if hasattr(source, "paths") else len(source.rows)
        chunks, labels = [], np.empty(n, np.int32)
        for start in range(0, n, encode_batch):
            idx = np.arange(start, min(start + encode_batch, n))
            batch = source.load_batch(idx, num_threads=num_threads)
            images = torch.from_numpy(batch["image"]).to(device)
            chunks.append(encode_fn(images).float().cpu().numpy())
            labels[idx] = batch["label"]
        self.latents = np.concatenate(chunks)
        self.labels = labels

    def epoch_indices(self) -> np.ndarray:
        return self.source.epoch_indices()

    def load_batch(self, chunk: np.ndarray, num_threads: int = 8) -> dict:
        return {"latent": self.latents[chunk], "label": self.labels[chunk]}
