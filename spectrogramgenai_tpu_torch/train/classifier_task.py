"""Classifier training task (``spectrogramgenai_tpu/train/classifier_task.py``) on one device.

Per step: renorm to [-1, 1] → [denoiser: renorm(x − denoiser(x))] →
channel adapt → forward (dropout, BatchNorm
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
are float32. The denoiser (``denoiser_apply``, a callable on [-1, 1] NHWC
images, see ``cli/train_classifiers.load_denoiser_apply``) is applied only
with ``cfg.use_denoiser``, as in the JAX task. :meth:`ClassifierTask.pretrained_variables`
merges converted ImageNet weights (a flax msgpack of
``tools/convert_torchvision.py``) into the initial weights, as the JAX
task's ``_load_pretrained`` does.
"""

from __future__ import annotations

import logging
from typing import Callable

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
HEAD_NAMES = frozenset({"fc", "classifier", "classifier_6", "fc2"})  # each net's final layer, trained afresh


def _flatten(tree: dict, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


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
    def __init__(self, cfg: ClassifierConfig, device: torch.device | str,
                 denoiser_apply: Callable[[torch.Tensor], torch.Tensor] | None = None):
        self.cfg = cfg
        self.denoiser_apply = denoiser_apply
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

    def pretrained_variables(self, path: str, variables: dict[str, torch.Tensor] | None = None
                             ) -> tuple[dict[str, torch.Tensor], int]:
        """(state_dict, count), as the JAX task's ``_load_pretrained``:
        ``variables`` (default: the seeded random init of :meth:`init_state`)
        with every parameter whose flax path and shape match one in the flax
        msgpack at ``path`` replaced by it, except the heads (``HEAD_NAMES``),
        and the BatchNorm running statistics likewise; the count is of the
        parameters taken from the file. Pass the state_dict to :meth:`init_state`."""
        from spectrogramgenai_tpu_torch.bridge import flax_from_state_dict, state_dict_from_flax
        from spectrogramgenai_tpu_torch.core import flax_msgpack

        module = self._build(False)
        if variables is None:
            variables = reset_classifier(module, torch.Generator().manual_seed(self.cfg.run.seed)).state_dict()
        loaded = flax_msgpack.read(path)
        tree = flax_from_state_dict(module, variables)
        flat_pre = _flatten(loaded.get("params", {}))
        merged, n_used = {}, 0
        for k, v in _flatten(tree["params"]).items():
            pre = flat_pre.get(k)
            if pre is not None and k[0] not in HEAD_NAMES and tuple(pre.shape) == v.shape:
                merged[k], n_used = pre, n_used + 1
            else:
                merged[k] = v
        tree["params"] = _unflatten(merged)
        if "batch_stats" in tree and "batch_stats" in loaded:
            flat_bs = _flatten(loaded["batch_stats"])
            tree["batch_stats"] = _unflatten({k: flat_bs[k] if k in flat_bs and tuple(flat_bs[k].shape) == v.shape
                                              else v for k, v in _flatten(tree["batch_stats"]).items()})
        logging.getLogger(__name__).info("loaded %d pretrained tensors from %s", n_used, path)
        return state_dict_from_flax(module, tree), n_used

    def load_state(self, state: TrainState, saved: dict) -> TrainState:
        """Restore a checkpoint's dict into ``state`` and the module."""
        state.load_state_dict(saved)
        self.model.load_state_dict(state.params, strict=False)
        return state

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """[0, 1] grayscale NHWC → [-1, 1] (less the denoiser's noise estimate,
        renormalised, with ``use_denoiser``) with the net's input channels."""
        x = renorm_m1_1(images.float())
        if self.denoiser_apply is not None and self.cfg.use_denoiser:
            x = renorm_m1_1(x - self.denoiser_apply(x))
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
