"""InceptionV3 and the score math of the Inception Score and the Fréchet distance.

Counterpart of ``spectrogramgenai_tpu/eval/inception.py``. :class:`InceptionV3`
is torchvision's ``inception_v3`` without the aux head, written with flax's
module names (which are torchvision's), so the converted ImageNet weights of
``tools/convert_torchvision.py`` load through ``bridge.state_dict_from_flax``:

  * BatchNorm in eval mode with eps 1e-3 (``models.classifiers.BatchNorm``);
  * max pools 3×3 stride 2 without padding (flax's VALID);
  * the branch pools of the A, C and E blocks are 3×3 stride-1 averages over
    a 1-pixel pad, counting the pad (torchvision) or, with ``fid_pool``, not
    counting it (pytorch-fid's patched blocks, the reference FID recipe);
  * the (1, 7), (7, 1), (1, 3) and (3, 1) convolutions pad only their long axis;
  * the 2048-d features are the spatial mean of the last block.

The module takes NHWC float input already scaled to [-1, 1], as the JAX
module does; the CLIs map uint8 images with :func:`inception_inputs`.
``inception_score``, ``gaussian_statistics`` and ``frechet_distance`` are
NumPy/SciPy copies of the JAX functions; they take class probabilities or
features from any network.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from spectrogramgenai_tpu_torch.models.classifiers import BatchNorm


class BasicConv2d(nn.Module):
    """Conv (no bias) → BatchNorm (eps 1e-3, running statistics) → ReLU."""

    def __init__(self, in_channels: int, features: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel, stride=stride, padding=padding, bias=False)
        self.bn = BatchNorm(features, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x), train=False))


def _avg_pool_same(x: torch.Tensor, count_include_pad: bool) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=count_include_pad)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int, fid_pool: bool = False):
        super().__init__()
        self.fid_pool = fid_pool
        self.branch1x1 = BasicConv2d(in_channels, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_same(x, not self.fid_pool))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int, fid_pool: bool = False):
        super().__init__()
        c7 = channels_7x7
        self.fid_pool = fid_pool
        self.branch1x1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_same(x, not self.fid_pool))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_channels: int, fid_pool: bool = False):
        super().__init__()
        self.fid_pool = fid_pool
        self.branch1x1 = BasicConv2d(in_channels, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(_avg_pool_same(x, not self.fid_pool))
        return torch.cat([self.branch1x1(x), b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """torchvision ``inception_v3`` without the aux head, for evaluation only.
    ``fid_pool`` selects pytorch-fid's branch pools (see the module docstring)."""

    def __init__(self, num_classes: int = 1000, fid_pool: bool = False):
        super().__init__()
        fp = fid_pool
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fp)
        self.Mixed_5c = InceptionA(256, 64, fp)
        self.Mixed_5d = InceptionA(288, 64, fp)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fp)
        self.Mixed_6c = InceptionC(768, 160, fp)
        self.Mixed_6d = InceptionC(768, 160, fp)
        self.Mixed_6e = InceptionC(768, 192, fp)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, fp)
        self.Mixed_7c = InceptionE(2048, fp)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor, return_features: bool = False) -> torch.Tensor:
        """(B, H, W, 3) float in [-1, 1] → (B, num_classes) float32 logits, or
        with ``return_features`` the (B, 2048) pool features."""
        x = x.permute(0, 3, 1, 2).float()
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        feats = x.mean(dim=(2, 3))
        return feats if return_features else self.fc(feats)


def inception_inputs(images_u8: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """(B, H, W, 3) uint8 → float32 in [-1, 1] on ``device``: x / 255, then (x − 0.5) / 0.5."""
    x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device).float() / 255.0
    return (x - 0.5) / 0.5


def load_inception_params(ckpt_path: str | None) -> dict | None:
    """The flax variables of a converted checkpoint (``inception_v3.msgpack``
    of ``tools/convert_torchvision.py``) as nested NumPy dicts, or None when
    no path is given or the file is missing."""
    from spectrogramgenai_tpu_torch.core import flax_msgpack

    if not ckpt_path or not os.path.exists(ckpt_path):
        return None
    return flax_msgpack.read(ckpt_path)


def build_inception(variables: dict | None, device: torch.device | str, fid_pool: bool = False) -> InceptionV3:
    """An eval-mode :class:`InceptionV3` on ``device`` holding ``variables``
    (flax, through ``bridge``), or with random weights from seed 0 (the
    port's own init, not JAX's ``PRNGKey(0)`` stream) when ``variables`` is None."""
    from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax
    from spectrogramgenai_tpu_torch.models.classifiers import reset_classifier

    model = InceptionV3(fid_pool=fid_pool)
    if variables is None:
        reset_classifier(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state_dict_from_flax(model, variables))
    return model.to(device).eval()


# ---------------------------------------------------------------------------
# Score math (model-independent)
# ---------------------------------------------------------------------------


def inception_score(probs: np.ndarray, splits: int = 10) -> tuple[float, float]:
    """torchmetrics semantics: per split, exp(E_x[KL(p(y|x) ‖ p(y))]); (mean, std) over the splits."""
    probs = np.asarray(probs, np.float64)
    scores = []
    for part in np.array_split(probs, splits):
        if len(part) == 0:
            continue
        marginal = part.mean(axis=0, keepdims=True)
        kl = np.sum(part * (np.log(part + 1e-12) - np.log(marginal + 1e-12)), axis=1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def gaussian_statistics(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mean, covariance) of (n, d) features, in float64."""
    features = np.asarray(features, np.float64)
    return features.mean(axis=0), np.cov(features, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """‖μ1 − μ2‖² + Tr(Σ1 + Σ2 − 2(Σ1Σ2)^{1/2}) (pytorch-fid's math): scipy's
    ``sqrtm``, retried with ``eps`` added to both diagonals when it is not finite."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))
