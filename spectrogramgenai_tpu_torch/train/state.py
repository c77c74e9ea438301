"""The train state (``spectrogramgenai_tpu/train/state.py``): everything a
resumable run needs, in one object.

Unlike the JAX pytree it is updated in place by the train step (the
optimizer's moments, the EMA copy and the generator are mutated, not rebuilt),
which keeps one copy of each on the device.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    step: int                            # optimizer updates so far
    params: dict[str, torch.Tensor]      # float32 master weights (UNet state_dict keys)
    opt: torch.optim.Optimizer           # AdamW over params.values(); holds the moments
    ema_params: dict[str, torch.Tensor]  # float32
    generator: torch.Generator           # t, noise and label-drop draws of the train step

    def opt_state(self) -> dict[str, torch.Tensor]:
        """The optimizer's moments by parameter name (``exp_avg.<name>``, ``exp_avg_sq.<name>``)."""
        out = {}
        for name, p in self.params.items():
            st = self.opt.state.get(p)
            if st:
                out[f"exp_avg.{name}"] = st["exp_avg"]
                out[f"exp_avg_sq.{name}"] = st["exp_avg_sq"]
        return out

    def state_dict(self) -> dict:
        """The checkpoint form (see core/checkpoint.py)."""
        return {"params": self.params, "ema_params": self.ema_params, "opt_state": self.opt_state(),
                "step": torch.tensor(self.step), "rng": self.generator.get_state()}

    @torch.no_grad()
    def load_state_dict(self, saved: dict) -> None:
        """Restore from :meth:`state_dict`'s form, copying into this state's tensors."""
        self.step = int(saved["step"])
        for name, p in self.params.items():
            p.copy_(saved["params"][name])
            self.ema_params[name].copy_(saved["ema_params"][name])
            if f"exp_avg.{name}" in saved["opt_state"]:
                self.opt.state[p] = {
                    "step": torch.tensor(float(self.step)),
                    "exp_avg": saved["opt_state"][f"exp_avg.{name}"].to(p.device, p.dtype),
                    "exp_avg_sq": saved["opt_state"][f"exp_avg_sq.{name}"].to(p.device, p.dtype),
                }
        self.generator.set_state(saved["rng"])
