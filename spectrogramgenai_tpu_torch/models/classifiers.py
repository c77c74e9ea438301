"""The classifier zoo in PyTorch, matching ``spectrogramgenai_tpu/models/classifiers.py``.

``CustomCNN``, ``ResNet18``, ``VGG16``, ``MobileNetV2`` and the
``EnsembleClassifier`` of the four, written by hand (no torchvision) with
flax's semantics. They take NHWC like the JAX models, run NCHW inside, and
return float32 logits; submodule names repeat the flax names, so a
state_dict key is the flax path joined with dots (``bridge.py``).

flax's semantics, not torch's:
  * ``BatchNorm`` computes its statistics in float32 as flax does
    (var = E[x²] − E[x]², clipped at 0; momentum 0.99; eps 1e-5) and keeps
    flax's running variance, the biased batch variance (``nn.BatchNorm2d``
    keeps the unbiased one). Its parameters and running statistics stay
    float32 in any compute dtype;
  * ``Dropout`` keeps an element with probability 1 − rate and scales it by
    1 / (1 − rate); the keep masks come from a :class:`DropoutKeep`, which
    draws them from a generator or hands out injected ones by module name;
  * the first Dense after a flatten reads the features in NHWC order, as
    flax flattens them: the port flattens in that order too.

A model's forward takes ``train``: batch statistics (updating the running
ones) and dropout, or the running statistics and no dropout. With
``freeze_prefix`` the layers before each net's trainable boundary
(:func:`trainable_mask`) run under ``torch.no_grad``, the counterpart of
the JAX models' ``stop_gradient``: they still run in train mode, so their
BatchNorms use and update batch statistics, but no backward passes through
them.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from spectrogramgenai_tpu_torch.models.layers import init_weights_

# the nets' input channels: the ImageNet-shaped backbones take 3, the custom CNN 1
MODEL_CHANNELS = {"resnet": 3, "vgg": 3, "mobilenet": 3, "custom": 1}
_ALIASES = {"resnet": "resnet", "resnet18": "resnet", "vgg": "vgg", "vgg16": "vgg", "mobilenet": "mobilenet",
            "mobilenet_v2": "mobilenet", "custom": "custom", "ensemble": "ensemble"}


def canonical_name(model_name: str) -> str:
    """``resnet18`` → ``resnet`` and so on; raises on an unknown name."""
    if model_name not in _ALIASES:
        raise ValueError(f"unknown classifier {model_name!r} (one of {sorted(_ALIASES)})")
    return _ALIASES[model_name]


def _frozen(flag: bool):
    return torch.no_grad() if flag else contextlib.nullcontext()


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).flatten(1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of NCHW (see the module docstring)."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x32 = x.float()
        if train:
            mean = x32.mean(dim=(0, 2, 3))
            var = (x32.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)


class DropoutKeep:
    """Where a train-mode forward's dropout keep masks come from: ``masks``
    (boolean, by the Dropout module's name, shaped as its input) where given
    — the tests inject the JAX side's — else draws from ``generator``."""

    def __init__(self, generator: torch.Generator | None = None, masks: dict[str, torch.Tensor] | None = None):
        self.generator = generator
        self.masks = masks or {}

    def __call__(self, name: str, x: torch.Tensor, rate: float) -> torch.Tensor:
        if name in self.masks:
            return self.masks[name].to(x.device)
        return torch.rand(x.shape, generator=self.generator, device=x.device) >= rate


class Dropout(nn.Module):
    def __init__(self, rate: float, name: str):
        super().__init__()
        self.rate, self.name = rate, name

    def forward(self, x: torch.Tensor, keep: DropoutKeep | None) -> torch.Tensor:
        """``keep`` None: identity (eval); else x / (1 − rate) where kept, 0 elsewhere."""
        if keep is None or self.rate == 0.0:
            return x
        return torch.where(keep(self.name, x, self.rate), x / (1.0 - self.rate), torch.zeros_like(x))


def _dtype(module: nn.Module) -> torch.dtype:
    return next(m.weight.dtype for m in module.modules() if isinstance(m, nn.Conv2d))


class CustomCNN(nn.Module):
    """4 × (conv 3×3 → ReLU → maxpool 2) → dropout → FC 256 → ReLU → dropout → FC."""

    def __init__(self, num_classes: int = 27, img_size: int = 256):
        super().__init__()
        chans = (1, 16, 32, 64, 128)
        for i in range(4):
            setattr(self, f"Conv_{i}", nn.Conv2d(chans[i], chans[i + 1], 3, padding=1))
        side = img_size // 16
        self.fc1 = nn.Linear(128 * side * side, 256)
        self.fc2 = nn.Linear(256, num_classes)
        self.Dropout_0, self.Dropout_1 = Dropout(0.5, "Dropout_0"), Dropout(0.5, "Dropout_1")

    def forward(self, x: torch.Tensor, train: bool = False, keep: DropoutKeep | None = None) -> torch.Tensor:
        keep = keep if train else None
        x = x.permute(0, 3, 1, 2).to(_dtype(self))
        for i in range(4):
            x = F.max_pool2d(F.relu(getattr(self, f"Conv_{i}")(x)), 2)
        x = self.Dropout_0(_flatten_nhwc(x), keep)
        x = self.Dropout_1(F.relu(self.fc1(x)), keep)
        return self.fc2(x).float()


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, strides: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, 3, stride=strides, padding=1, bias=False)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.BatchNorm_1 = BatchNorm(features)
        if strides != 1 or in_channels != features:
            self.downsample_conv = nn.Conv2d(in_channels, features, 1, stride=strides, bias=False)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(y + x)


class ResNet18(nn.Module):
    """Trainable boundary: ``layer4`` and ``fc``."""

    STAGES = (64, 128, 256, 512)

    def __init__(self, num_classes: int = 27, freeze_prefix: bool = False):
        super().__init__()
        self.freeze_prefix = freeze_prefix
        self.stem_conv = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = BatchNorm(64)
        in_c = 64
        for stage, feats in enumerate(self.STAGES):
            for block in range(2):
                strides = 2 if (stage > 0 and block == 0) else 1
                setattr(self, f"layer{stage + 1}_{block}", BasicBlock(in_c, feats, strides))
                in_c = feats
        self.fc = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False, keep: DropoutKeep | None = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(_dtype(self))
        with _frozen(self.freeze_prefix):
            x = F.max_pool2d(F.relu(self.stem_bn(self.stem_conv(x), train)), 3, stride=2, padding=1)
            for stage in range(3):
                for block in range(2):
                    x = getattr(self, f"layer{stage + 1}_{block}")(x, train)
        for block in range(2):
            x = getattr(self, f"layer4_{block}")(x, train)
        return self.fc(x.mean(dim=(2, 3))).float()


class VGG16(nn.Module):
    """Trainable boundary: ``conv_11``, ``conv_12`` and the classifier."""

    PLAN = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
    POOL_AFTER = (1, 3, 6, 9, 12)  # each block's last conv

    def __init__(self, num_classes: int = 27, freeze_prefix: bool = False):
        super().__init__()
        self.freeze_prefix = freeze_prefix
        in_c, idx = 3, 0
        for block in self.PLAN:
            for feats in block:
                setattr(self, f"conv_{idx}", nn.Conv2d(in_c, feats, 3, padding=1))
                in_c, idx = feats, idx + 1
        self.classifier_0 = nn.Linear(512 * 7 * 7, 4096)
        self.classifier_3 = nn.Linear(4096, 4096)
        self.classifier_6 = nn.Linear(4096, num_classes)
        self.Dropout_0, self.Dropout_1 = Dropout(0.5, "Dropout_0"), Dropout(0.5, "Dropout_1")

    def _conv(self, x: torch.Tensor, idx: int) -> torch.Tensor:
        x = F.relu(getattr(self, f"conv_{idx}")(x))
        return F.max_pool2d(x, 2) if idx in self.POOL_AFTER else x

    def forward(self, x: torch.Tensor, train: bool = False, keep: DropoutKeep | None = None) -> torch.Tensor:
        keep = keep if train else None
        x = x.permute(0, 3, 1, 2).to(_dtype(self))
        with _frozen(self.freeze_prefix):
            for idx in range(11):
                x = self._conv(x, idx)
        for idx in (11, 12):
            x = self._conv(x, idx)
        x = _flatten_nhwc(F.adaptive_avg_pool2d(x, (7, 7)))
        x = self.Dropout_0(F.relu(self.classifier_0(x)), keep)
        x = self.Dropout_1(F.relu(self.classifier_3(x)), keep)
        return self.classifier_6(x).float()


class InvertedResidual(nn.Module):
    def __init__(self, in_channels: int, features: int, strides: int, expand: int):
        super().__init__()
        hidden = in_channels * expand
        self.residual = strides == 1 and in_channels == features
        names = iter(range(3))
        if expand != 1:
            i = next(names)
            setattr(self, f"Conv_{i}", nn.Conv2d(in_channels, hidden, 1, bias=False))
            setattr(self, f"BatchNorm_{i}", BatchNorm(hidden))
        i = next(names)
        setattr(self, f"Conv_{i}", nn.Conv2d(hidden, hidden, 3, stride=strides, padding=1, groups=hidden,
                                             bias=False))
        setattr(self, f"BatchNorm_{i}", BatchNorm(hidden))
        i = next(names)
        setattr(self, f"Conv_{i}", nn.Conv2d(hidden, features, 1, bias=False))
        setattr(self, f"BatchNorm_{i}", BatchNorm(features))
        self.n_convs = i + 1

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = x
        for i in range(self.n_convs):
            y = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(y), train)
            if i < self.n_convs - 1:
                y = F.relu6(y)
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    """Trainable boundary: ``features_17``, ``features_18`` (+ its BatchNorm) and the classifier."""

    # (expand t, out channels c, repeats n, stride s), torchvision's plan
    PLAN = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))

    def __init__(self, num_classes: int = 27, freeze_prefix: bool = False):
        super().__init__()
        self.freeze_prefix = freeze_prefix
        self.features_0 = nn.Conv2d(3, 32, 3, stride=2, padding=1, bias=False)
        self.features_0_bn = BatchNorm(32)
        in_c, idx = 32, 1
        for t, c, n, s in self.PLAN:
            for i in range(n):
                setattr(self, f"features_{idx}", InvertedResidual(in_c, c, s if i == 0 else 1, t))
                in_c, idx = c, idx + 1
        self.features_18 = nn.Conv2d(in_c, 1280, 1, bias=False)
        self.features_18_bn = BatchNorm(1280)
        self.Dropout_0 = Dropout(0.2, "Dropout_0")
        self.classifier = nn.Linear(1280, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False, keep: DropoutKeep | None = None) -> torch.Tensor:
        keep = keep if train else None
        x = x.permute(0, 3, 1, 2).to(_dtype(self))
        with _frozen(self.freeze_prefix):
            x = F.relu6(self.features_0_bn(self.features_0(x), train))
            for idx in range(1, 17):
                x = getattr(self, f"features_{idx}")(x, train)
        x = self.features_17(x, train)
        x = F.relu6(self.features_18_bn(self.features_18(x), train))
        return self.classifier(self.Dropout_0(x.mean(dim=(2, 3)), keep)).float()


class EnsembleClassifier(nn.Module):
    """The four nets' logits, concatenated → ReLU → Linear. The sub-models
    always run in eval mode; only the fusion head trains."""

    def __init__(self, num_classes: int = 27, img_size: int = 256, freeze_prefix: bool = False):
        super().__init__()
        self.freeze_prefix = freeze_prefix
        self.resnet = ResNet18(num_classes)
        self.vgg = VGG16(num_classes)
        self.mobilenet = MobileNetV2(num_classes)
        self.custom = CustomCNN(num_classes, img_size)
        self.classifier = nn.Linear(4 * num_classes, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False, keep: DropoutKeep | None = None) -> torch.Tensor:
        x1 = x if x.shape[-1] == 1 else x.mean(dim=-1, keepdim=True)
        x3 = x1.expand(*x1.shape[:-1], 3)
        with _frozen(self.freeze_prefix):
            logits = torch.cat([self.resnet(x3), self.vgg(x3), self.mobilenet(x3), self.custom(x1)], dim=-1)
        return self.classifier(F.relu(logits).to(self.classifier.weight.dtype)).float()


def build_classifier(model_name: str, num_classes: int, img_size: int = 256, freeze_prefix: bool = False
                     ) -> nn.Module:
    """The net for ``model_name`` (``resnet``/``resnet18``, ``vgg``/``vgg16``,
    ``mobilenet``/``mobilenet_v2``, ``custom``, ``ensemble``), float32 and
    zero-initialised; :func:`reset_classifier` gives it seeded weights. The
    custom CNN's first Dense depends on ``img_size``."""
    name = canonical_name(model_name)
    if name == "resnet":
        return ResNet18(num_classes, freeze_prefix)
    if name == "vgg":
        return VGG16(num_classes, freeze_prefix)
    if name == "mobilenet":
        return MobileNetV2(num_classes, freeze_prefix)
    if name == "custom":
        return CustomCNN(num_classes, img_size)
    return EnsembleClassifier(num_classes, img_size, freeze_prefix)


def reset_classifier(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights (``layers.init_weights_``: kernels normal(0,
    1/√fan_in), biases 0); BatchNorm scale 1, offset 0, running mean 0 and
    variance 1."""
    init_weights_(module, generator)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return module


def _trainable(name: str, top: str) -> bool:
    if name == "resnet":
        return top.startswith("layer4") or top == "fc"
    if name == "vgg":
        return top in ("conv_11", "conv_12") or top.startswith("classifier")
    if name == "mobilenet":
        return top in ("features_17", "features_18", "features_18_bn", "classifier")
    if name == "ensemble":
        return top == "classifier"
    return True  # custom


def trainable_mask(module: nn.Module, model_name: str) -> dict[str, bool]:
    """The layer-freeze policy (the JAX ``trainable_mask``) by parameter
    name, applied as each parameter's ``requires_grad``: resnet trains
    layer4 + fc; vgg the last two convs + the classifier; mobilenet
    features_17/18 + the classifier; the ensemble its fusion head only; the
    custom CNN everything."""
    name = canonical_name(model_name)
    mask = {}
    for key, p in module.named_parameters():
        mask[key] = _trainable(name, key.split(".")[0])
        p.requires_grad_(mask[key])
    return mask
