"""Conditional DDPM task (``spectrogramgenai_tpu/train/diffusion_task.py``).

Builds the UNet (and, in latent mode, the frozen VQ-VAE) for a ``DDPMConfig``
and
  * trains: renorm → [frozen VQ encode] → q-sample → UNet ε-MSE → AdamW /
    OneCycle update → EMA update (``train_step``);
  * samples: reverse chain → [clamp → codebook quantize → VQ decode] → clamp
    → uint8.
The attention kernels (forward and backward) are on when the device is CUDA,
as the JAX task turns the Pallas kernels on when the backend is a TPU.

Dtypes. The module runs in the config's compute dtype (the whole UNet cast,
as for serving; the codebook stays float32). Training keeps float32 masters
in the ``TrainState`` — params, AdamW moments, EMA — as flax's
``dtype=bfloat16`` does: the module is a working copy, refreshed from the
masters after every update, and its gradients are cast to float32 before
AdamW. The JAX package's SA remat is a TPU workaround and is not ported.

Over a mesh (``core/mesh.py``; the default is one rank) the UNet's
parameters are split by ``cfg.run.param_sharding`` (``train/common.ShardPlan``),
a step's gradients are reduced over the data group, and its random draws
(t, noise) are made for the global microbatch alike on every rank, each rank
keeping its rows: an R-rank step computes what the one-rank step computes on
the same global batch, up to summation order. The metrics are global means.
"""

from __future__ import annotations

import torch

from spectrogramgenai_tpu_torch.core.config import DDPMConfig
from spectrogramgenai_tpu_torch.core.mesh import Mesh
from spectrogramgenai_tpu_torch.core.ema import ema_init, ema_update
from spectrogramgenai_tpu_torch.data.transforms import renorm_m1_1
from spectrogramgenai_tpu_torch.diffusion.ddpm import (
    DiffusionSchedule,
    ddim_sample,
    ddpm_sample,
    diffusion_loss,
    dpmpp_sample,
    linear_schedule,
    to_uint8,
)
from spectrogramgenai_tpu_torch.models.unet import ConditionalUNet
from spectrogramgenai_tpu_torch.models.vqvae import VQVAE
from spectrogramgenai_tpu_torch.train.common import (
    ShardPlan,
    make_adamw_onecycle,
    microbatch_accumulate,
    microbatch_split,
    optimizer_update,
)
from spectrogramgenai_tpu_torch.train.state import TrainState
from spectrogramgenai_tpu_torch.utils.profiling import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DiffusionTask:
    def __init__(self, cfg: DDPMConfig, device: torch.device | str,
                 vq_params: dict[str, torch.Tensor] | None = None, total_steps: int = 1,
                 mesh: Mesh | None = None):
        self.cfg = cfg
        self.total_steps = total_steps  # length of the OneCycle schedule
        self.device = torch.device(device)
        self.mesh = Mesh(self.device) if mesh is None else mesh
        self.dtype = _DTYPES[cfg.compute_dtype]
        self.schedule: DiffusionSchedule = linear_schedule(cfg.noise_steps, cfg.beta_start, cfg.beta_end)

        if cfg.latent:
            if vq_params is None:
                raise ValueError("latent diffusion needs trained VQ-VAE weights (cfg.vqae_ckpt)")
            self.sample_size = cfg.img_size // cfg.latent_downscale
            self.channels = cfg.latent_dim
            self.vqvae = VQVAE(hidden_dim=cfg.vq_hidden_dim, latent_dim=cfg.latent_dim,
                               n_embeddings=cfg.vq_n_embeddings)
            self.vqvae.load_state_dict(vq_params)
            self.vqvae.to(self.device).eval()
            self.vqvae.encoder.to(self.dtype)
            self.vqvae.decoder.to(self.dtype)
        else:
            self.sample_size = cfg.img_size
            self.channels = cfg.c_in
            self.vqvae = None

        self.model = self._unet(fused=self.device.type == "cuda")
        self.model.to(device=self.device, dtype=self.dtype).eval()
        self.plan = ShardPlan(self.model, self.mesh, cfg.run.param_sharding)
        self.lr = None  # the lr schedule, set by init_state

    def _unet(self, fused: bool) -> ConditionalUNet:
        cfg = self.cfg
        return ConditionalUNet(c_in=self.channels, c_out=self.channels, time_dim=cfg.time_dim,
                               num_classes=cfg.num_classes, remove_deep_conv=cfg.remove_deep_conv,
                               width_mult=cfg.width_mult, fused_attention=fused)

    def load_params(self, params: dict[str, torch.Tensor]) -> None:
        """Copy a UNet state_dict (e.g. a checkpoint's params or ema_params) into the model."""
        self.plan.load_module(self.model, params)

    # -- state -----------------------------------------------------------------
    def init_state(self, seed: int | None = None,
                   params: dict[str, torch.Tensor] | None = None) -> TrainState:
        """A fresh TrainState: seeded random weights (or copies of ``params``)
        as float32 masters on the device (this rank's shards), AdamW, the EMA
        copy and the train step's generator; the module is loaded with the
        weights."""
        seed = self.cfg.run.seed if seed is None else seed
        if params is None:
            params = self._unet(fused=False).reset_parameters(torch.Generator().manual_seed(seed)).state_dict()
        masters = self.plan.masters(params, self.device)
        opt, self.lr = make_adamw_onecycle(list(masters.values()), self.cfg.lr, self.total_steps,
                                           eps=self.cfg.adam_eps)
        self.load_params(params)
        return TrainState(step=0, params=masters, opt=opt, ema_params=ema_init(masters),
                          generator=torch.Generator(device=self.device).manual_seed(seed), plan=self.plan)

    def load_state(self, state: TrainState, saved: dict) -> TrainState:
        """Restore a checkpoint's dict into ``state`` and the module."""
        state.load_state_dict(saved)
        self.load_params(saved["params"])
        return state

    # -- embedding into latent space --------------------------------------------
    @torch.no_grad()
    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """[0, 1] grayscale NHWC → model input space: renorm to [-1, 1], then in
        latent mode the frozen VQ encoder (unquantized, float32)."""
        x = renorm_m1_1(images.float())
        return self.vqvae.encode(x) if self.vqvae is not None else x

    def make_encoder(self):
        """The batch encode for latent caching (frozen and deterministic, so it
        can run once per image instead of once per image and epoch)."""
        return self.encode

    # -- train ------------------------------------------------------------------
    def train_step(self, state: TrainState, batch: torch.Tensor, labels: torch.Tensor, *,
                   encoded: bool = False, t: torch.Tensor | None = None, noise: torch.Tensor | None = None,
                   keep=None) -> tuple[TrainState, dict[str, torch.Tensor]]:
        """One optimizer update on ``batch`` (images in [0, 1], or latents when
        ``encoded``), updating ``state`` in place. With ``grad_accum`` = k the
        batch runs as k microbatches, each with its own t, noise and label-keep
        draw, and their mean gradient makes one update. ``t`` (n,), ``noise``
        (the model-space shape of the batch) and ``keep`` (one flag per
        microbatch) may be given instead of drawn from ``state.generator``.
        The whole step is the span ``sgai.train.step``."""
        with span("sgai.train.step"):
            k = max(1, int(self.cfg.grad_accum))
            rows = {"x": batch, "y": labels}
            if t is not None:
                rows["t"] = t
            if noise is not None:
                rows["noise"] = noise
            microbatches = microbatch_split(rows, k)
            if keep is not None:
                for mb, flag in zip(microbatches, torch.as_tensor(keep).reshape(k), strict=True):
                    mb["keep"] = flag

            def loss_fn(mb: dict) -> tuple[torch.Tensor, dict]:
                x = mb["x"] if encoded else self.encode(mb["x"])
                t, noise = self._draws(x, state.generator, mb.get("t"), mb.get("noise"))
                return diffusion_loss(self.model, self.schedule, x, mb["y"], label_drop=self.cfg.label_drop,
                                      generator=state.generator, t=t, noise=noise, keep=mb.get("keep")), {}

            names = list(state.params)
            module = dict(self.model.named_parameters())
            working = [module[name] for name in names]
            loss, grads, _ = microbatch_accumulate(loss_fn, microbatches, working)
            for group in state.opt.param_groups:
                group["lr"] = self.lr(state.step)
            optimizer_update(state.opt, list(state.params.values()), grads, working, self.plan, names)
            ema_update(state.ema_params, state.params, state.step, self.cfg.ema_beta, self.cfg.ema_start)
            state.step += 1
            return state, self.mesh.mean_over_data({"train_mse": loss})

    def _draws(self, x: torch.Tensor, generator: torch.Generator | None, t: torch.Tensor | None,
               noise: torch.Tensor | None) -> tuple[torch.Tensor | None, torch.Tensor | None]:
        """The t and noise that ``diffusion_loss`` would draw, drawn for the
        global microbatch and cut to this rank's rows (the label-keep draw
        that follows is one for the whole microbatch, alike on every rank)."""
        n, dev = x.shape[0], x.device
        if t is None:
            t = self.mesh.draw_rows(lambda m: torch.randint(1, self.schedule.noise_steps, (m,), generator=generator,
                                                            device=dev), n)
        if noise is None:
            noise = self.mesh.draw_rows(lambda m: torch.randn((m, *x.shape[1:]), generator=generator, device=dev,
                                                              dtype=x.dtype), n)
        return t, noise

    @torch.no_grad()
    def eval_step(self, state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                  generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """ε-MSE of the current params on images, with no label drop (the
        global batch's mean over a mesh)."""
        x = self.encode(images)
        t, noise = self._draws(x, generator, None, None)
        return self.mesh.mean_over_data({"val_mse": diffusion_loss(
            self.model, self.schedule, x, labels, label_drop=0.0, generator=generator, t=t, noise=noise)})

    # -- sampling ----------------------------------------------------------------
    @torch.inference_mode()
    def sample_latents(self, labels, *, generator: torch.Generator | None = None,
                       x_T: torch.Tensor | None = None, cfg_scale: float | None = None,
                       sampler: str = "ddpm", num_steps: int = 50, randn=None) -> torch.Tensor:
        """The reverse chain alone, in the span ``sgai.sample.chain``: (n, S,
        S, C) float32, before any clamp. ``randn`` as in
        ``diffusion.ddpm.ddpm_sample``."""
        cfg_scale = self.cfg.cfg_scale if cfg_scale is None else cfg_scale
        labels = torch.as_tensor(labels, dtype=torch.long, device=self.device)
        shape = (self.sample_size, self.sample_size, self.channels)
        kw = dict(generator=generator, x_T=x_T, randn=randn)
        with span("sgai.sample.chain"):
            if sampler == "ddim":
                return ddim_sample(self.model, self.schedule, labels, shape, num_steps=num_steps,
                                   cfg_scale=cfg_scale, **kw)
            if sampler == "dpmpp":
                return dpmpp_sample(self.model, self.schedule, labels, shape, num_steps=num_steps,
                                    cfg_scale=cfg_scale, **kw)
            if sampler == "ddpm":
                return ddpm_sample(self.model, self.schedule, labels, shape, cfg_scale=cfg_scale, **kw)
        raise ValueError(f"unknown sampler {sampler!r}")

    @torch.inference_mode()
    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """Chain output → uint8 images (n, H, W, 1); latent mode quantizes and decodes first."""
        if self.vqvae is not None:
            x = self.vqvae.decode_quantized(torch.clamp(x, -1.0, 1.0))
        return to_uint8(x)

    def sample(self, labels, *, generator: torch.Generator | None = None,
               x_T: torch.Tensor | None = None, cfg_scale: float | None = None,
               sampler: str = "ddpm", num_steps: int = 50) -> torch.Tensor:
        """Generate uint8 samples (n, H, W, 1) on the task's device.

        Over a data group of D ranks, when D divides the n labels (as the JAX
        task shards them), each rank runs the chain on its block of them,
        with its rows of the draws for all n (x_T and the DDPM chain's
        noise, or of the given ``x_T``), and the images are gathered: every
        rank returns the n images of the one-rank call. Otherwise every rank
        runs all n."""
        mesh = self.mesh
        labels = torch.as_tensor(labels, dtype=torch.long, device=self.device)
        n = labels.shape[0]
        if mesh.data == 1 or n % mesh.data:
            x = self.sample_latents(labels, generator=generator, x_T=x_T, cfg_scale=cfg_scale,
                                    sampler=sampler, num_steps=num_steps)
            return self.decode(x)
        rows = slice(mesh.data_index * (n // mesh.data), (mesh.data_index + 1) * (n // mesh.data))

        def randn(shape):
            return mesh.draw_rows(lambda m: torch.randn((m, *shape[1:]), generator=generator, device=self.device),
                                  shape[0])

        x = self.sample_latents(labels[rows], generator=generator, x_T=None if x_T is None else x_T[rows],
                                cfg_scale=cfg_scale, sampler=sampler, num_steps=num_steps, randn=randn)
        return mesh.gather_rows(self.decode(x))
