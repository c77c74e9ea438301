"""The one traffic generator: everything a run feeds the system, made from
``--seed`` and the parameters of the cell's traffic mix
(``traffic/<mix>.json``, named by ``workloads/<cell>.json``). Every seed gets the same sizes and counts, in
another order, so that seeds change which numbers are fed and not how much
work there is.

  * labels: passes over the classes, each chain's or each run's in a seeded order;
  * the starting noise of a chain: a generator on the device seeded per chain;
  * a corpus of synthetic spectrogram-like images (uint8, on the device) with
    balanced labels, read in seeded epoch permutations;
  * training draws (t, ε, label keep), made on the device;
  * open-loop arrivals: one fixed pattern, uniform over the window (a
    Poisson process conditioned on its count), turned by a seeded shift,
    with balanced labels.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose, from the run's seed and tags."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(subseed(seed, *tags))


def balanced_labels(n: int, classes: int, seed: int, *tags) -> np.ndarray:
    """``n`` labels cycling over the classes, in a seeded order."""
    return rng(seed, "labels", *tags).permutation(np.arange(n) % classes).astype(np.int64)


def chain_labels(traffic: dict, classes: int, seed: int, chain: int) -> np.ndarray:
    """The labels of chain ``chain``: ``rounds`` passes over every class."""
    return balanced_labels(traffic["rounds"] * classes, classes, seed, "chain", chain)


def chain_seed(seed: int, chain: int) -> int:
    """The seed of the device generator from which chain ``chain`` draws its x_T."""
    return subseed(seed, "x_T", chain)


def corpus(n: int, size: int, classes: int, seed: int, device, chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` synthetic (size, size, 1) uint8 images on the device, smooth
    fields with a few horizontal bands and fine noise, and their labels."""
    g = torch.Generator(device=device).manual_seed(subseed(seed, "corpus"))
    out = torch.empty((n, size, size, 1), dtype=torch.uint8, device=device)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        coarse = F.interpolate(torch.randn((m, 1, 8, 8), generator=g, device=device), size=(size, size),
                               mode="bilinear", align_corners=False)
        bands = torch.sin(torch.linspace(0, 1, size, device=device)[None, :] *
                          torch.rand((m, 1), generator=g, device=device) * 60.0)[:, None, :, None]
        x = coarse + 0.5 * bands + 0.2 * torch.randn((m, 1, size, size), generator=g, device=device)
        lo = x.amin(dim=(1, 2, 3), keepdim=True)
        hi = x.amax(dim=(1, 2, 3), keepdim=True)
        out[i:i + m] = ((x - lo) / (hi - lo) * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1)
    return out, torch.as_tensor(balanced_labels(n, classes, seed, "corpus"), device=device)


def epoch_order(n: int, batch: int, seed: int, epochs: int) -> np.ndarray:
    """The corpus rows of ``epochs`` epochs, each a seeded permutation cut to
    whole batches: step i reads rows [i·batch, (i+1)·batch)."""
    return np.concatenate([rng(seed, "epoch", e).permutation(n)[: n // batch * batch] for e in range(epochs)])


class TrainDraws:
    """The random draws of the DDPM's training steps, made on the device from one generator."""

    def __init__(self, seed: int, device, noise_steps: int, label_drop: float):
        self.g = torch.Generator(device=device).manual_seed(subseed(seed, "train_draws"))
        self.device, self.noise_steps, self.label_drop = device, noise_steps, label_drop

    def __call__(self, shape: tuple[int, ...]) -> dict[str, torch.Tensor]:
        g, dev = self.g, self.device
        return {"t": torch.randint(1, self.noise_steps, (shape[0],), generator=g, device=dev),
                "noise": torch.randn(shape, generator=g, device=dev),
                "keep": torch.rand((1,), generator=g, device=dev) >= self.label_drop}


def arrivals(traffic: dict, seconds: float, classes: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Open-loop arrival offsets (s from the window's start, sorted) and labels.
    Every seed gets the same round(rate · seconds) arrivals on the circle of
    the window: one pattern, uniform over the window (a Poisson process
    given its count), drawn from the mix's ``pattern_seed``; the run's seed
    turns the circle by a shift (the same gaps in another order) and orders
    the labels."""
    n = int(round(traffic["rate_per_s"] * seconds))
    gaps = rng(traffic["pattern_seed"], "gaps").exponential(1.0, n + 1)
    pattern = np.cumsum(gaps[:n]) / gaps.sum() * seconds
    shift = rng(seed, "arrivals").uniform(0.0, seconds)
    return np.sort((pattern + shift) % seconds), balanced_labels(n, classes, seed, "requests")
