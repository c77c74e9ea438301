"""Classifier training task (``spectrogramgenai_tpu/train/classifier_task.py``) on one device.

Per step: renorm to [-1, 1] → channel adapt → forward (dropout, BatchNorm
batch statistics) → cross-entropy [+ knowledge distillation against
BirdNET embeddings: KL at temperature T, weight α] → Adam over the
trainable parameters only (``models/classifiers.trainable_mask``; the
frozen prefix runs under ``torch.no_grad``, so its parameters stay
bit-equal to their initial values while its BatchNorms still update their
running statistics). With ``grad_accum`` = k the batch runs as k
microbatches in order, the running statistics threading through them, and
their mean gradient makes ONE update. Evaluation (``eval_step``) uses the
running statistics and no dropout. The ensemble's sub-models always run in
eval mode; only its fusion head trains.

Dtypes, as in ``train/diffusion_task.py``: the convolutions and dense
layers run in the config's compute dtype as a working copy of the float32
masters in the ``TrainState`` (params and Adam moments), refreshed after
every update; BatchNorm (parameters and running statistics) and the losses
are float32. The denoiser preprocessing (``use_denoiser``) is not ported:
asking for it raises.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from spectrogramgenai_tpu_torch.core.config import ClassifierConfig
from spectrogramgenai_tpu_torch.data.transforms import expand_channels, renorm_m1_1
from spectrogramgenai_tpu_torch.models.classifiers import (
    MODEL_CHANNELS,
    DropoutKeep,
    build_classifier,
    canonical_name,
    reset_classifier,
    trainable_mask,
)
from spectrogramgenai_tpu_torch.train.common import (
    make_adam,
    microbatch_accumulate,
    microbatch_split,
    optimizer_update,
)
from spectrogramgenai_tpu_torch.train.state import TrainState

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long())


def kd_loss(logits: torch.Tensor, teacher_emb: torch.Tensor, temperature: float) -> torch.Tensor:
    """BirdNET-embedding distillation: KL between the softened teacher and
    the student's log-probabilities, summed, over the batch, times T²."""
    soft_targets = torch.softmax(teacher_emb.float() / temperature, dim=-1)
    soft_prob = torch.log_softmax(logits.float() / temperature, dim=-1)
    per_batch = (soft_targets * (torch.log(soft_targets + 1e-12) - soft_prob)).sum()
    return per_batch / logits.shape[0] * temperature**2


class ClassifierTask:
    def __init__(self, cfg: ClassifierConfig, device: torch.device | str):
        if cfg.use_denoiser:
            raise NotImplementedError("the denoiser preprocessing (use_denoiser) is not ported yet")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = _DTYPES[cfg.compute_dtype]
        self.name = canonical_name(cfg.model_name)
        self.n_channel = MODEL_CHANNELS.get(self.name, 1)
        self.model = self._build(freeze_prefix=True).to(self.device)
        for m in self.model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(self.dtype)
        self.mask = trainable_mask(self.model, cfg.model_name)

    def _build(self, freeze_prefix: bool) -> nn.Module:
        return build_classifier(self.cfg.model_name, self.cfg.num_classes, self.cfg.data.img_size,
                                freeze_prefix=freeze_prefix)

    def init_state(self, seed: int | None = None, variables: dict[str, torch.Tensor] | None = None) -> TrainState:
        """A fresh TrainState: seeded random weights (or copies of
        ``variables``, the net's state_dict) as float32 masters on the
        device, Adam over the trainable ones, and the BatchNorm running
        statistics as stats; the module is loaded with them."""
        seed = self.cfg.run.seed if seed is None else seed
        if variables is None:
            variables = reset_classifier(self._build(False), torch.Generator().manual_seed(seed)).state_dict()
        self.model.load_state_dict(variables)
        masters = {k: variables[k].detach().to(self.device, torch.float32).clone()
                   for k, _ in self.model.named_parameters()}
        opt = make_adam([p for k, p in masters.items() if self.mask[k]], self.cfg.lr)
        return TrainState(step=0, params=masters, opt=opt,
                          generator=torch.Generator(device=self.device).manual_seed(seed),
                          stats=dict(self.model.named_buffers()))

    def load_state(self, state: TrainState, saved: dict) -> TrainState:
        """Restore a checkpoint's dict into ``state`` and the module."""
        state.load_state_dict(saved)
        self.model.load_state_dict(state.params, strict=False)
        return state

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """[0, 1] grayscale NHWC → [-1, 1] with the net's input channels."""
        x = renorm_m1_1(images.float())
        return x if self.name == "ensemble" else expand_channels(x, self.n_channel)

    def train_step(self, state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                   embeddings: torch.Tensor | None = None, keep: dict[str, torch.Tensor] | None = None
                   ) -> tuple[TrainState, dict[str, torch.Tensor]]:
        """One Adam update on ``images`` ([0, 1] NHWC) and ``labels``, updating
        ``state`` and the running statistics in place; returns the mean loss
        and accuracy. ``keep`` (boolean dropout masks for the whole batch, by
        Dropout module name) may be given instead of drawn from
        ``state.generator``."""
        k = max(1, int(self.cfg.grad_accum))
        rows = {"im": images, "la": labels}
        if embeddings is not None:
            rows["emb"] = embeddings
        rows.update({f"keep.{name}": m for name, m in (keep or {}).items()})

        def loss_fn(mb: dict):
            masks = {name[len("keep."):]: m for name, m in mb.items() if name.startswith("keep.")}
            logits = self.model(self.preprocess(mb["im"]), train=True, keep=DropoutKeep(state.generator, masks))
            loss = cross_entropy(logits, mb["la"])
            if "emb" in mb and self.cfg.knowledge_dist:
                dist = kd_loss(logits, mb["emb"], self.cfg.kd_temperature)
                loss = self.cfg.kd_alpha * dist + (1.0 - self.cfg.kd_alpha) * loss
            acc = (logits.argmax(-1) == mb["la"]).float().mean()
            return loss, {"train_loss": loss, "train_acc": acc}

        module = dict(self.model.named_parameters())
        names = [name for name in state.params if self.mask[name]]
        working = [module[name] for name in names]
        _, grads, aux = microbatch_accumulate(loss_fn, microbatch_split(rows, k), working)
        optimizer_update(state.opt, [state.params[name] for name in names], grads, working)
        state.step += 1
        return state, aux

    @torch.no_grad()
    def eval_step(self, state: TrainState, images: torch.Tensor, labels: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """(float32 logits, mean cross-entropy) with the running statistics and no dropout."""
        logits = self.model(self.preprocess(images), train=False)
        return logits, cross_entropy(logits, labels)
