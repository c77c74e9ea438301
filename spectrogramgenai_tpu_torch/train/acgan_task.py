"""ACGAN training task (``spectrogramgenai_tpu/train/acgan_task.py``) on one device.

One step trains both players: the generator on BCE(real) + NLL(class) of
the discriminator's judgement of its fakes (halved; 0.33 × the sum with the
acoustic-index MSE under ``use_aind``), the discriminator on the real batch
and the detached fakes (quarter-weighted sums), each with RMSprop (lr 0.002,
α 0.99, eps 1e-8 outside the square root). Both gradients are taken at the
pre-step parameters: the generator's fakes are judged by the pre-step
discriminator, run without updating its spectral-norm state; the
discriminator sees the pre-step generator's fakes. The discriminator's real
pass updates each spectral norm's ``u`` and its fake pass starts from that
updated ``u``. With ``grad_accum`` = k the batch runs as k microbatches in
order, the generator's BatchNorm statistics and the discriminator's ``u``
threading through them, and the mean gradients make ONE RMSprop update each.

The random draws (the fakes' labels and the noise) come from the state's
generator unless the step is given them: the two packages' streams differ,
so the tests inject the JAX side's.

Dtypes, as in ``train/diffusion_task.py``: the convolutions and dense layers
run in the config's compute dtype as a working copy of the float32 masters
(params and RMSprop's ν), refreshed after every update; BatchNorm (its
parameters and running statistics), the spectral-norm layers (their weights
and ``u``, as flax's ``SpectralNorm`` keeps them) and the losses are
float32. As in the JAX task, ``cfg.num_blocks`` does not reach the
generator, which has 4 blocks (ROADMAP queue 3); a test swaps in another
generator before ``init_state``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn as nn

from spectrogramgenai_tpu_torch.core.config import ACGANConfig
from spectrogramgenai_tpu_torch.data.transforms import renorm_m1_1
from spectrogramgenai_tpu_torch.models import gan
from spectrogramgenai_tpu_torch.models.gan import Discriminator, Generator
from spectrogramgenai_tpu_torch.train.common import make_rmsprop, microbatch_split, optimizer_update

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``nn.BCELoss`` on sigmoid outputs (mean), with the prediction clipped to
    [1e-7, 1 − 1e-7] as the JAX task clips it (torch clamps the log at −100)."""
    pred = pred.clamp(1e-7, 1.0 - 1e-7)
    return -(target * torch.log(pred) + (1.0 - target) * torch.log(1.0 - pred)).mean()


def nll(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``nn.NLLLoss`` on log-softmax outputs (mean)."""
    return -log_probs.gather(1, labels.long()[:, None]).mean()


@dataclasses.dataclass
class GANTrainState:
    step: int                                 # updates so far (one per player per step)
    g_params: dict[str, torch.Tensor]         # float32 masters of the generator
    g_opt: torch.optim.RMSprop
    d_params: dict[str, torch.Tensor]         # float32 masters of the discriminator
    d_opt: torch.optim.RMSprop
    generator: torch.Generator                # the step's draws: fake labels, noise
    g_stats: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)  # BatchNorm running statistics
    d_stats: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)  # spectral norm's u and σ

    @staticmethod
    def _moments(opt: torch.optim.Optimizer, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return {f"square_avg.{name}": opt.state[p]["square_avg"] for name, p in params.items() if opt.state.get(p)}

    def state_dict(self) -> dict:
        """The checkpoint form: each player's module state_dict (params and stats) and RMSprop's ν."""
        return {"g_params": {**self.g_params, **self.g_stats}, "d_params": {**self.d_params, **self.d_stats},
                "g_opt": self._moments(self.g_opt, self.g_params), "d_opt": self._moments(self.d_opt, self.d_params),
                "step": torch.tensor(self.step), "rng": self.generator.get_state()}

    @torch.no_grad()
    def load_state_dict(self, saved: dict) -> None:
        """Restore from :meth:`state_dict`'s form, copying into this state's tensors."""
        self.step = int(saved["step"])
        for params, stats, opt, p_key, o_key in ((self.g_params, self.g_stats, self.g_opt, "g_params", "g_opt"),
                                                  (self.d_params, self.d_stats, self.d_opt, "d_params", "d_opt")):
            for name, t in {**params, **stats}.items():
                t.copy_(saved[p_key][name])
            for name, p in params.items():
                if f"square_avg.{name}" in saved[o_key]:
                    opt.state[p] = {"step": torch.tensor(float(self.step)),
                                    "square_avg": saved[o_key][f"square_avg.{name}"].to(p.device, p.dtype)}
        self.generator.set_state(saved["rng"])


class ACGANTask:
    def __init__(self, cfg: ACGANConfig, device: torch.device | str,
                 denoiser_apply: Callable[[torch.Tensor], torch.Tensor] | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = _DTYPES[cfg.compute_dtype]
        self.total_noise = cfg.noise_dim + cfg.num_classes + (cfg.n_ind if cfg.use_aind else 0)
        self.generator = Generator(noise_dim=self.total_noise)
        self.discriminator = Discriminator(n_classes=cfg.num_classes, n_ind=cfg.n_ind if cfg.use_aind else None,
                                           img_size=cfg.data.img_size)
        self.denoiser_apply = denoiser_apply  # optional: x ← renorm(x − denoiser(x))

    def _place(self, module: nn.Module) -> nn.Module:
        """On the device, with the plain convolutions and dense layers in the compute dtype."""
        module.to(self.device)
        for m in module.modules():
            if type(m) in (nn.Conv2d, nn.Linear):
                m.to(self.dtype)
        return module

    def init_state(self, seed: int | None = None, g_variables: dict[str, torch.Tensor] | None = None,
                   d_variables: dict[str, torch.Tensor] | None = None) -> GANTrainState:
        """A fresh state: seeded random weights (or copies of ``g_variables`` /
        ``d_variables``, the modules' state_dicts) as float32 masters on the
        device, RMSprop for each, and the modules' buffers as stats; the
        modules are loaded with them."""
        seed = self.cfg.run.seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed)
        masters = []
        for module, variables in ((self.generator, g_variables), (self.discriminator, d_variables)):
            if variables is None:
                variables = gan.reset_gan(module.to("cpu", torch.float32), gen).state_dict()
            self._place(module).load_state_dict(variables)
            masters.append({k: variables[k].detach().to(self.device, torch.float32).clone()
                            for k, _ in module.named_parameters()})
        cfg = self.cfg
        return GANTrainState(
            step=0, g_params=masters[0], d_params=masters[1],
            g_opt=make_rmsprop(list(masters[0].values()), cfg.lr, cfg.rmsprop_alpha, cfg.rmsprop_eps),
            d_opt=make_rmsprop(list(masters[1].values()), cfg.lr, cfg.rmsprop_alpha, cfg.rmsprop_eps),
            generator=torch.Generator(device=self.device).manual_seed(seed),
            g_stats=dict(self.generator.named_buffers()), d_stats=dict(self.discriminator.named_buffers()))

    def load_state(self, state: GANTrainState, saved: dict) -> GANTrainState:
        """Restore a checkpoint's dict into ``state`` and the modules."""
        state.load_state_dict(saved)
        self.generator.load_state_dict(state.g_params, strict=False)
        self.discriminator.load_state_dict(state.d_params, strict=False)
        return state

    def build_noise(self, labels: torch.Tensor, a_ind: torch.Tensor | None = None,
                    generator: torch.Generator | None = None, normal: torch.Tensor | None = None) -> torch.Tensor:
        """(n, total_noise): N(0, 1) with the one-hot labels (and indices) written in."""
        return gan.build_noise(labels, self.total_noise - self.cfg.num_classes, self.cfg.num_classes, a_ind,
                               generator=generator, normal=normal)

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """[0, 1] NHWC → [-1, 1], then the denoiser's residual where one is given."""
        x = renorm_m1_1(images.float())
        if self.denoiser_apply is not None:
            x = renorm_m1_1(x - self.denoiser_apply(x))
        return x

    def _losses(self, outs, target: torch.Tensor, labels: torch.Tensor, a_ind: torch.Tensor | None):
        if self.cfg.use_aind:
            validity, log_probs, aind_out = outs
            return 0.33 * (bce(validity, target) + nll(log_probs, labels) + (aind_out - a_ind).square().mean())
        validity, log_probs = outs
        return (bce(validity, target) + nll(log_probs, labels)) / 2.0

    def _micro_grads(self, mb: dict, g_working: list[torch.Tensor], d_working: list[torch.Tensor]):
        """One microbatch's generator and discriminator gradients at the current
        params and its metrics; updates the BatchNorm statistics and ``u``."""
        real = self.preprocess(mb["im"])
        n = real.shape[0]
        valid = torch.ones(n, 1, device=real.device)
        fake = torch.zeros(n, 1, device=real.device)
        a_ind = mb.get("aind")

        gen_imgs = self.generator(mb["z"], train=True)
        loss_g = self._losses(self.discriminator(gen_imgs, train=False), valid, mb["fl"], a_ind)
        g_grads = torch.autograd.grad(loss_g, g_working)

        outs_real = self.discriminator(real, train=True)  # updates each u
        outs_fake = self.discriminator(gen_imgs.detach(), train=True)  # from the updated u
        loss_d = (self._losses(outs_real, valid, mb["la"], a_ind) + self._losses(outs_fake, fake, mb["fl"], a_ind)) / 2
        d_grads = torch.autograd.grad(loss_d, d_working)
        preds = torch.cat([outs_real[1].argmax(1), outs_fake[1].argmax(1)])
        acc = (preds == torch.cat([mb["la"], mb["fl"]]).long()).float().mean()
        return g_grads, d_grads, {"loss_G": loss_g.detach(), "loss_D": loss_d.detach(), "d_acc": acc}

    def train_step(self, state: GANTrainState, images: torch.Tensor, labels: torch.Tensor,
                   a_ind: torch.Tensor | None = None, z: torch.Tensor | None = None,
                   fake_labels: torch.Tensor | None = None) -> tuple[GANTrainState, dict[str, torch.Tensor]]:
        """One RMSprop update of each player on ``images`` ([0, 1] NHWC) and
        ``labels``; the fakes' labels and noise ``z`` (n, total_noise) are drawn
        from ``state.generator`` unless given. Returns the mean losses and the
        discriminator's class accuracy over real and fake."""
        cfg = self.cfg
        n = images.shape[0]
        if fake_labels is None:
            fake_labels = torch.randint(0, cfg.num_classes, (n,), generator=state.generator, device=images.device)
        if z is None:
            z = self.build_noise(fake_labels, a_ind if cfg.use_aind else None, generator=state.generator)
        rows = {"im": images, "la": labels, "fl": fake_labels, "z": z}
        if a_ind is not None:
            rows["aind"] = a_ind.float()

        g_module, d_module = dict(self.generator.named_parameters()), dict(self.discriminator.named_parameters())
        g_working = [g_module[name] for name in state.g_params]
        d_working = [d_module[name] for name in state.d_params]
        k = max(1, int(cfg.grad_accum))
        g_sum = d_sum = metrics = None
        for mb in microbatch_split(rows, k):
            g_grads, d_grads, m = self._micro_grads(mb, g_working, d_working)
            g_grads, d_grads = [g.float() for g in g_grads], [g.float() for g in d_grads]
            if g_sum is None:
                g_sum, d_sum, metrics = g_grads, d_grads, m
            else:
                torch._foreach_add_(g_sum, g_grads)
                torch._foreach_add_(d_sum, d_grads)
                metrics = {key: metrics[key] + v for key, v in m.items()}
        if k > 1:
            torch._foreach_div_(g_sum, float(k))
            torch._foreach_div_(d_sum, float(k))
            metrics = {key: v / k for key, v in metrics.items()}
        optimizer_update(state.g_opt, list(state.g_params.values()), g_sum, g_working)
        optimizer_update(state.d_opt, list(state.d_params.values()), d_sum, d_working)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def generate(self, state: GANTrainState, z: torch.Tensor) -> torch.Tensor:
        """The generator on the running statistics: (n, H, W, 1) float32."""
        return self.generator(z, train=False)
