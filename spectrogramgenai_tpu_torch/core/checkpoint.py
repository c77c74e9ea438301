"""The port's checkpoints: ``torch.save`` of state_dicts, one directory per step.

Layout, as in the JAX package: ``<directory>/step_XXXXXXXXXX/`` holding
``state.pt`` and ``meta.json`` (``{"step": …, "metric": …}``), the newest
``max_to_keep`` kept; ``save(…, best=True, metric=m)`` also mirrors the
checkpoint to ``<directory>/best/`` (never collected) with ``m`` in its
``meta.json``, and ``restore(best=True)`` reads that mirror back: the
classifier sweep keeps its best-validation checkpoint this way.
``state.pt`` is a dict of state_dicts and tensors, ``train/state.py``'s
``TrainState.state_dict`` for a training run:

  * ``"params"``: the module's state_dict, float32 parameters and their
    non-parameter state together (the VQ-VAE's codebook buffers
    ``embedding`` / ``ema_count`` / ``ema_weight``, BatchNorm's running mean
    and variance);
  * ``"opt_state"``: the Adam or AdamW moments by parameter name, ``"step"``
    and ``"rng"`` (the train step's generator state);
  * a DDPM run (``models/<run_name>``) also ``"ema_params"``, the EMA UNet.

So a VQ-VAE checkpoint (``cli/train_vqvae.py``, read by
``DDPMConfig.vqae_ckpt``) is ``{"params": …}`` with the VQVAE state_dict
plus its train state, and serving reads a DDPM run's ``params`` or
``ema_params`` alone.

Floating tensors are saved float32 on the CPU, others as they are, and
loaded with ``weights_only=True``.
The JAX package's flax msgpack checkpoints are not read here (that needs
flax); ``bridge.py`` converts flax parameters held in memory.
"""

from __future__ import annotations

import json
import os
import shutil

import torch


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def _best_dir(self) -> str:
        return os.path.join(self.directory, "best")

    def save(self, step: int, state: dict, *, best: bool = False, metric: float | None = None) -> str:
        """Write ``state`` (a dict of state_dicts and tensors) as step ``step``;
        keep the newest few; with ``best``, mirror it to ``best/``."""
        def to_host(v: torch.Tensor) -> torch.Tensor:
            return v.detach().to("cpu", torch.float32) if v.is_floating_point() else v.detach().cpu()

        host = {name: to_host(sd) if isinstance(sd, torch.Tensor) else {k: to_host(v) for k, v in sd.items()}
                for name, sd in state.items()}
        meta = {"step": int(step), "metric": metric}
        target = self._step_dir(int(step))
        self._write(target, host, meta)
        if best:
            self._write(self._best_dir(), host, meta)
        for s in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        return target

    @staticmethod
    def _write(target: str, host: dict, meta: dict) -> None:
        tmp = target + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        torch.save(host, os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(target):
            shutil.rmtree(target)
        os.replace(tmp, target)

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name[len("step_"):]) for name in os.listdir(self.directory)
                      if name.startswith("step_") and not name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, best: bool = False) -> dict | None:
        """The saved dict (on the CPU) of ``step`` (default the latest), or of
        the ``best/`` mirror; None if there is no such checkpoint."""
        if best:
            path = self._best_dir()
            if not os.path.isdir(path):
                return None
        else:
            step = self.latest_step() if step is None else step
            if step is None:
                return None
            path = self._step_dir(step)
        return torch.load(os.path.join(path, "state.pt"), map_location="cpu", weights_only=True)

    def best_meta(self) -> dict | None:
        """``best/meta.json`` (``{"step": …, "metric": …}``), or None."""
        path = os.path.join(self._best_dir(), "meta.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)
