"""Source-separation ("specunet") task (``spectrogramgenai_tpu/train/specunet_task.py``) on one device.

Trains the transformer denoiser (``models/denoiser.py``) on ε-mixed
spectrogram triples (``audio/mix.py``) with MSE and Adam (lr 1e-3). In
"separate" mode it maps the mix to 2 channels, the noise and the bird
spectrograms; in "denoise" mode to 1 channel, the noise, which the
classifiers then subtract (``x − net(x)``). Dropout (0.1) draws its keep
masks from the state's generator unless the step is given them (the tests
inject the JAX side's). With ``grad_accum`` = k the batch runs as k
microbatches and their mean gradient makes ONE Adam update.

Dtypes, as in ``train/diffusion_task.py``: the convolutions and dense layers
run in the config's compute dtype as a working copy of the float32 masters
(params and Adam moments), refreshed after every update; LayerNorm and the
loss are float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from spectrogramgenai_tpu_torch.core.config import SpecUNetConfig
from spectrogramgenai_tpu_torch.models.classifiers import DropoutKeep
from spectrogramgenai_tpu_torch.models.denoiser import TransformerDenoiser
from spectrogramgenai_tpu_torch.models.layers import init_weights_
from spectrogramgenai_tpu_torch.train.common import (
    make_adam,
    microbatch_accumulate,
    microbatch_split,
    optimizer_update,
)
from spectrogramgenai_tpu_torch.train.state import TrainState

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SpecUNetTask:
    def __init__(self, cfg: SpecUNetConfig, device: torch.device | str):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = _DTYPES[cfg.compute_dtype]
        self.denoise_mode = cfg.mode == "denoise"
        self.model = TransformerDenoiser(out_channels=1 if self.denoise_mode else 2)

    def init_state(self, seed: int | None = None, variables: dict[str, torch.Tensor] | None = None) -> TrainState:
        """A fresh TrainState: seeded random weights (or copies of
        ``variables``, the model's state_dict) as float32 masters on the
        device and Adam; the module is loaded with them, its convolutions and
        dense layers in the compute dtype."""
        seed = self.cfg.run.seed if seed is None else seed
        if variables is None:
            variables = init_weights_(self.model.to("cpu", torch.float32), torch.Generator().manual_seed(seed)
                                      ).state_dict()
        self.model.to(self.device)
        for m in self.model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                m.to(self.dtype)
        self.model.load_state_dict(variables)
        masters = {k: variables[k].detach().to(self.device, torch.float32).clone()
                   for k, _ in self.model.named_parameters()}
        return TrainState(step=0, params=masters, opt=make_adam(list(masters.values()), self.cfg.lr),
                          generator=torch.Generator(device=self.device).manual_seed(seed))

    def train_step(self, state: TrainState, mix: torch.Tensor, noise_spec: torch.Tensor, bird_spec: torch.Tensor,
                   keep: dict[str, torch.Tensor] | None = None) -> tuple[TrainState, dict[str, torch.Tensor]]:
        """One Adam update on NHWC (B, H, W, 1) spectrograms; returns the mean
        ``train_mse``. ``keep`` (boolean dropout masks for the whole batch, by
        Dropout path) may be given instead of drawn from ``state.generator``."""
        target = noise_spec if self.denoise_mode else torch.cat([noise_spec, bird_spec], dim=-1)
        rows = {"mix": mix, "target": target, **{f"keep.{name}": m for name, m in (keep or {}).items()}}

        def loss_fn(mb: dict):
            masks = {name[len("keep."):]: m for name, m in mb.items() if name.startswith("keep.")}
            pred = self.model(mb["mix"], keep=DropoutKeep(state.generator, masks))
            loss = (pred - mb["target"].float()).square().mean()
            return loss, {"train_mse": loss}

        module = dict(self.model.named_parameters())
        working = [module[name] for name in state.params]
        k = max(1, int(self.cfg.grad_accum))
        _, grads, aux = microbatch_accumulate(loss_fn, microbatch_split(rows, k), working)
        optimizer_update(state.opt, list(state.params.values()), grads, working)
        state.step += 1
        return state, aux

    @torch.no_grad()
    def separate(self, state: TrainState, mix: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(predicted noise (B, H, W, 1), predicted bird (B, H, W, 1) — empty in denoise mode), float32."""
        pred = self.model(mix)
        return pred[..., :1], pred[..., 1:]
