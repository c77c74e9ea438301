"""VQ-VAE training task (``spectrogramgenai_tpu/train/vqvae_task.py``).

Loss = reconstruction MSE + commitment β·mean‖z − sg(z_q)‖² + codebook loss,
Adam. The EMA codebook update runs inside the train forward (the codebook's
buffers, which the ``TrainState`` holds as its ``stats``). With
``grad_accum`` = k the batch runs as k microbatches in order, microbatch i
quantizing against the codebook that microbatch i − 1 updated, and their
mean gradient makes ONE Adam update.

Dtypes, as in ``train/diffusion_task.py``: the encoder and decoder run in
the config's compute dtype as a working copy of the float32 masters in the
``TrainState`` (params and Adam moments), refreshed after every update; the
codebook and the losses are float32.

Over a mesh (``core/mesh.py``) the parameters are split by
``cfg.run.param_sharding`` (``train/common.ShardPlan``), the gradients are
reduced over the data group, the codebook's EMA uses the global batch's
counts and sums (so it stays bit-identical on every rank) and the metrics
are global means.
"""

from __future__ import annotations

import torch

from spectrogramgenai_tpu_torch.core.config import VQVAEConfig
from spectrogramgenai_tpu_torch.core.mesh import Mesh
from spectrogramgenai_tpu_torch.data.transforms import renorm_m1_1
from spectrogramgenai_tpu_torch.models.vqvae import VQVAE
from spectrogramgenai_tpu_torch.train.common import (
    ShardPlan,
    bind_mesh,
    make_adam,
    microbatch_accumulate,
    microbatch_split,
    optimizer_update,
)
from spectrogramgenai_tpu_torch.train.state import TrainState
from spectrogramgenai_tpu_torch.utils.profiling import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class VQVAETask:
    def __init__(self, cfg: VQVAEConfig, device: torch.device | str, mesh: Mesh | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = Mesh(self.device) if mesh is None else mesh
        self.dtype = _DTYPES[cfg.compute_dtype]
        self.model = self._vqvae().to(self.device)
        self.model.encoder.to(self.dtype)
        self.model.decoder.to(self.dtype)
        self.plan = ShardPlan(self.model, self.mesh, cfg.run.param_sharding)
        bind_mesh(self.model, self.mesh)

    def _vqvae(self) -> VQVAE:
        cfg = self.cfg
        return VQVAE(input_dim=cfg.input_dim, hidden_dim=cfg.hidden_dim, latent_dim=cfg.latent_dim,
                     n_embeddings=cfg.n_embeddings, commitment_cost=cfg.commitment_cost,
                     ema_decay=cfg.ema_decay, ema_eps=cfg.ema_eps)

    def init_state(self, seed: int | None = None, variables: dict[str, torch.Tensor] | None = None) -> TrainState:
        """A fresh TrainState: seeded random weights and codebook (or copies of
        ``variables``, a VQVAE state_dict) as float32 masters on the device,
        Adam, and the codebook buffers as stats; the module is loaded with them."""
        seed = self.cfg.run.seed if seed is None else seed
        if variables is None:
            variables = self._vqvae().reset_parameters(torch.Generator().manual_seed(seed)).state_dict()
        self.plan.load_module(self.model, variables)
        masters = self.plan.masters({k: variables[k] for k, _ in self.model.named_parameters()}, self.device)
        return TrainState(step=0, params=masters, opt=make_adam(list(masters.values()), self.cfg.lr),
                          generator=torch.Generator(device=self.device).manual_seed(seed),
                          stats=dict(self.model.named_buffers()), plan=self.plan)

    def load_state(self, state: TrainState, saved: dict) -> TrainState:
        """Restore a checkpoint's dict into ``state`` and the module."""
        state.load_state_dict(saved)
        self.plan.load_module(self.model, saved["params"])
        return state

    # -- train ------------------------------------------------------------------
    def _losses(self, x: torch.Tensor, train: bool):
        x_hat, _, _, commit, codebook, perplexity = self.model(x, train=train)
        recon = (x_hat - x).square().mean()
        return recon + commit + codebook, recon, commit, codebook, perplexity

    def train_step(self, state: TrainState, images: torch.Tensor) -> tuple[TrainState, dict[str, torch.Tensor]]:
        """One Adam update on ``images`` ([0, 1] NHWC), updating ``state`` and
        the codebook in place; returns the mean loss terms and perplexity.
        The whole step is the span ``sgai.train.step``."""
        with span("sgai.train.step"):
            k = max(1, int(self.cfg.grad_accum))

            def loss_fn(mb: dict):
                loss, recon, commit, codebook, perplexity = self._losses(renorm_m1_1(mb["x"].float()), train=True)
                return loss, {"recon_mse": recon, "commitment": commit, "codebook": codebook,
                              "perplexity": perplexity, "loss": loss}

            names = list(state.params)
            module = dict(self.model.named_parameters())
            working = [module[name] for name in names]
            _, grads, aux = microbatch_accumulate(loss_fn, microbatch_split({"x": images}, k), working)
            optimizer_update(state.opt, list(state.params.values()), grads, working, self.plan, names)
            state.step += 1
            return state, self.mesh.mean_over_data(aux)

    @torch.no_grad()
    def eval_step(self, state: TrainState, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """The loss of the current params on images, with no codebook update."""
        loss, recon, _, _, perplexity = self._losses(renorm_m1_1(images.float()), train=False)
        return self.mesh.mean_over_data({"val_loss": loss, "val_recon_mse": recon, "val_perplexity": perplexity})

    @torch.no_grad()
    def reconstruct(self, state: TrainState, images: torch.Tensor):
        """(x_hat, z, z_q), NHWC float32, for the reconstruction figure."""
        x_hat, z, z_q, *_ = self.model(renorm_m1_1(images.float()), train=False)
        return x_hat, z, z_q
