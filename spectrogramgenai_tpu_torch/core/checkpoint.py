"""The port's checkpoints: ``torch.save`` of state_dicts, one directory per step.

Layout, as in the JAX package: ``<directory>/step_XXXXXXXXXX/`` holding
``state.pt`` and ``meta.json``. ``state.pt`` is a dict of state_dicts and
tensors:

  * a DDPM run (``models/<run_name>``): ``{"params": …, "ema_params": …}``,
    two UNet state_dicts, and from a training run also ``"opt_state"`` (the
    AdamW moments by parameter name), ``"step"`` and ``"rng"`` (the train
    step's generator state), ``train/state.py``'s ``TrainState.state_dict``;
  * a VQ-VAE (``DDPMConfig.vqae_ckpt``): ``{"params": …}``, the VQVAE
    state_dict with its codebook buffers.

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

    def save(self, step: int, state: dict) -> str:
        """Write ``state`` (a dict of state_dicts and tensors) as step ``step``; keep the newest few."""
        def to_host(v: torch.Tensor) -> torch.Tensor:
            return v.detach().to("cpu", torch.float32) if v.is_floating_point() else v.detach().cpu()

        host = {name: to_host(sd) if isinstance(sd, torch.Tensor) else {k: to_host(v) for k, v in sd.items()}
                for name, sd in state.items()}
        target = self._step_dir(int(step))
        tmp = target + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        torch.save(host, os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": int(step)}, f)
        if os.path.exists(target):
            shutil.rmtree(target)
        os.replace(tmp, target)
        for s in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        return target

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name[len("step_"):]) for name in os.listdir(self.directory)
                      if name.startswith("step_") and not name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> dict | None:
        """The saved dict (on the CPU), or None if there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(os.path.join(self._step_dir(step), "state.pt"), map_location="cpu",
                          weights_only=True)
