"""The train state (``spectrogramgenai_tpu/train/state.py``): everything a
resumable run needs, in one object.

Unlike the JAX pytree it is updated in place by the train step (the
optimizer's moments, the EMA copy, the stats and the generator are mutated,
not rebuilt), which keeps one copy of each on the device.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    step: int                            # optimizer updates so far
    params: dict[str, torch.Tensor]      # float32 master weights (the module's parameter names)
    opt: torch.optim.Optimizer           # Adam or AdamW over (some of) params.values(); holds the moments
    generator: torch.Generator           # the train step's random draws
    ema_params: dict[str, torch.Tensor] | None = None  # float32 (the DDPM)
    # the module's non-parameter state, the module's own buffers (the same
    # tensors, which its forward updates in place): the VQ-VAE's codebook,
    # BatchNorm's running mean and variance
    stats: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

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
        """The checkpoint form (see core/checkpoint.py): ``params`` is the
        module's state_dict, parameters and stats together."""
        out = {"params": {**self.params, **self.stats}, "opt_state": self.opt_state(),
               "step": torch.tensor(self.step), "rng": self.generator.get_state()}
        if self.ema_params is not None:
            out["ema_params"] = self.ema_params
        return out

    @torch.no_grad()
    def load_state_dict(self, saved: dict) -> None:
        """Restore from :meth:`state_dict`'s form, copying into this state's tensors."""
        self.step = int(saved["step"])
        for name, t in self.stats.items():
            t.copy_(saved["params"][name])
        for name, p in self.params.items():
            p.copy_(saved["params"][name])
            if self.ema_params is not None:
                self.ema_params[name].copy_(saved["ema_params"][name])
            if f"exp_avg.{name}" in saved["opt_state"]:
                self.opt.state[p] = {
                    "step": torch.tensor(float(self.step)),
                    "exp_avg": saved["opt_state"][f"exp_avg.{name}"].to(p.device, p.dtype),
                    "exp_avg_sq": saved["opt_state"][f"exp_avg_sq.{name}"].to(p.device, p.dtype),
                }
        self.generator.set_state(saved["rng"])
