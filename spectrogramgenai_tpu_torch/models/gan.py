"""The ACGAN's generator and discriminator in PyTorch, matching ``spectrogramgenai_tpu/models/gan.py``.

  * ``Generator``: Dense(noise → 512·16·16), read as NHWC (16, 16, 512) as
    flax reshapes it, → ``num_blocks`` GeneratorBlocks (512 → 256 → 128 →
    64 → 32 channels, nearest ×2 upsample each) → CBAM → 3×3 conv → 1
    channel, float32.
  * ``GeneratorBlock`` applies ``conv1`` and ``bn1`` twice in a row with the
    same weights (the reference's weight-tied double conv): in train mode
    ``bn1``'s running statistics take two updates in sequence.
  * ``CBAM``: channel attention (a shared bias-free MLP over the avg- and
    max-pooled channels, ratio 16) times spatial attention (channel mean and
    max → 7×7 conv).
  * ``Discriminator``: a plain 3×3 conv 1 → 16, four spectral-norm stride-2
    conv blocks 16 → 256 with LeakyReLU(0.2), a flatten in NHWC order as flax
    flattens, and spectral-norm heads: real/fake sigmoid, class log-softmax
    and, with ``n_ind``, the acoustic-index regression head.

The models take and return NHWC like the JAX ones and run NCHW inside;
submodule names repeat the flax names (``bridge.py``). BatchNorm is
``classifiers.BatchNorm`` (flax's semantics: biased variance, momentum
0.99, float32 statistics in any compute dtype).

``SpectralNorm`` is flax's ``nn.SpectralNorm``, not
``torch.nn.utils.spectral_norm``: the kernel viewed as a (fan_in, out)
matrix W, ``u`` of shape (1, out) kept as a buffer; every forward runs one
power iteration from ``u`` (v = n(u·Wᵀ), u' = n(v·W), n(x) = x/√(Σx² +
1e-12)), σ = v·W·u'ᵀ and the weight W/σ, with no gradient through u' and v
but one through σ. ``u`` and ``σ`` are stored only with ``update_stats``;
without it (the discriminator in the generator's step) the fresh σ is used
and dropped. Biases are left alone. The weight stays float32 in any compute
dtype, as the flax parameter does; W/σ is cast to the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from spectrogramgenai_tpu_torch.models.classifiers import BatchNorm, reset_classifier


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


class _SpectralNorm:
    """The power iteration and the normalised weight (mixed into a Conv2d or Linear)."""

    def _sn_init(self, out_features: int) -> None:
        self.register_buffer("u", torch.ones(1, out_features))
        self.register_buffer("sigma", torch.ones(()))

    def spectral_weight(self, update_stats: bool) -> torch.Tensor:
        w = self.weight
        mat = w.reshape(w.shape[0], -1)  # (out, fan_in): flax's (fan_in, out) matrix, transposed
        with torch.no_grad():
            v = _l2_normalize(self.u @ mat)
            u = _l2_normalize(v @ mat.T)
        sigma = (v @ mat.T @ u.T)[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


class SpectralNormConv2d(nn.Conv2d, _SpectralNorm):
    """flax ``nn.SpectralNorm(nn.Conv(...))``; forward(x, update_stats)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._sn_init(self.out_channels)

    def forward(self, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
        w = self.spectral_weight(update_stats).to(x.dtype)
        return F.conv2d(x, w, self.bias.to(x.dtype), self.stride, self.padding)


class SpectralNormLinear(nn.Linear, _SpectralNorm):
    """flax ``nn.SpectralNorm(nn.Dense(...))``; forward(x, update_stats)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._sn_init(self.out_features)

    def forward(self, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
        w = self.spectral_weight(update_stats).to(x.dtype)
        return F.linear(x, w, self.bias.to(x.dtype))


SpectralNorm = (SpectralNormConv2d, SpectralNormLinear)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """NCHW nearest-neighbour ×scale."""
    return x.repeat_interleave(scale, dim=2).repeat_interleave(scale, dim=3)


class GeneratorBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.bn1 = BatchNorm(in_channels)
        self.conv2 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.bn2 = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x_init = x
        x = F.relu(self.bn1(self.conv1(x), train))  # the same conv1 and bn1, twice
        x = F.relu(self.bn1(self.conv1(x), train))
        x = upsample_nearest(x + x_init, 2)
        return F.relu(self.bn2(self.conv2(x), train))


class ChannelAttention(nn.Module):
    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        hidden = max(1, channels // ratio)
        self.fc1 = nn.Linear(channels, hidden, bias=False)
        self.fc2 = nn.Linear(hidden, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg, mx = x.mean(dim=(2, 3)), x.amax(dim=(2, 3))
        out = self.fc2(F.relu(self.fc1(avg))) + self.fc2(F.relu(self.fc1(mx)))
        return torch.sigmoid(out)[:, :, None, None]


class SpatialAttention(nn.Module):
    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.Conv_0 = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.Conv_0(y))


class CBAM(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.ChannelAttention_0 = ChannelAttention(channels)
        self.SpatialAttention_0 = SpatialAttention()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ChannelAttention_0(x) * x
        return self.SpatialAttention_0(x) * x


class Generator(nn.Module):
    """(B, noise_dim) noise + one-hot (+ indices) → (B, 16·2^num_blocks, same, 1) float32."""

    def __init__(self, noise_dim: int = 91, output_channels: int = 1, num_blocks: int = 4):
        super().__init__()
        self.num_blocks = num_blocks
        self.initial = nn.Linear(noise_dim, 512 * 16 * 16)
        out_c = 512
        for i in range(num_blocks):
            in_c, out_c = 512 // 2**i, 512 // 2 ** (i + 1)
            setattr(self, f"block_{i}", GeneratorBlock(in_c, out_c))
        self.CBAM_0 = CBAM(out_c)
        self.final_conv = nn.Conv2d(out_c, output_channels, 3, padding=1)

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.initial(z.to(self.initial.weight.dtype))
        x = x.view(z.shape[0], 16, 16, 512).permute(0, 3, 1, 2)  # flax's NHWC reshape
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, train)
        x = self.final_conv(self.CBAM_0(x))
        return x.permute(0, 2, 3, 1).float()


class Discriminator(nn.Module):
    """(B, H, W, 1) → (validity (B, 1), class log-probs (B, n_classes)[, indices (B, n_ind)]), float32."""

    def __init__(self, n_classes: int = 27, n_blocks: int = 4, n_ind: int | None = None, img_size: int = 256):
        super().__init__()
        self.n_blocks, self.n_ind = n_blocks, n_ind
        self.conv1 = nn.Conv2d(1, 16, 3, padding=1)
        in_c = 16
        for i in range(n_blocks):
            out_c = 16 * 2 ** (i + 1)
            setattr(self, f"block_{i}_conv", SpectralNormConv2d(in_c, out_c, 3, stride=2, padding=1))
            in_c = out_c
        side = img_size
        for _ in range(n_blocks):
            side = (side - 1) // 2 + 1
        features = in_c * side * side
        self.layer_rf = SpectralNormLinear(features, 1)
        self.layer_c = SpectralNormLinear(features, n_classes)
        if n_ind is not None:
            self.layer_ai = SpectralNormLinear(features, n_ind)

    def forward(self, x: torch.Tensor, train: bool = True):
        x = self.conv1(x.permute(0, 3, 1, 2).to(self.conv1.weight.dtype))
        for i in range(self.n_blocks):
            x = F.leaky_relu(getattr(self, f"block_{i}_conv")(x, train), 0.2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # NHWC order, as flax flattens
        rf = torch.sigmoid(self.layer_rf(x, train).float())
        c = torch.log_softmax(self.layer_c(x, train).float(), dim=-1)
        if self.n_ind is not None:
            return rf, c, self.layer_ai(x, train).float()
        return rf, c


@torch.no_grad()
def reset_gan(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights (``classifiers.reset_classifier``: kernels
    normal(0, 1/√fan_in), biases 0, BatchNorm scale 1, offset 0, running mean
    0, variance 1) and spectral norm's ``u`` normal(0, 1), σ 1, as flax
    initialises them."""
    reset_classifier(module, generator)
    for m in module.modules():
        if isinstance(m, SpectralNorm):
            m.u.copy_(torch.randn(m.u.shape, generator=generator))
            m.sigma.fill_(1.0)
    return module


def build_noise(labels: torch.Tensor, noise_dim: int, num_classes: int, a_ind: torch.Tensor | None = None,
                generator: torch.Generator | None = None, normal: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's noise: an N(0, 1) vector of ``noise_dim + num_classes``
    entries (``normal``, where given, else drawn from ``generator``) whose
    first ``num_classes`` entries are overwritten by the one-hot label and the
    next ``a_ind.shape[-1]`` by the acoustic indices."""
    n = labels.shape[0]
    if normal is None:
        normal = torch.randn(n, noise_dim + num_classes, generator=generator, device=labels.device)
    z = normal.float().clone()
    # scatter, not F.one_hot: on a CUDA tensor its range check waits for the device
    z[:, :num_classes] = torch.zeros(n, num_classes, device=z.device).scatter_(1, labels.long()[:, None], 1.0)
    if a_ind is not None:
        z[:, num_classes:num_classes + a_ind.shape[-1]] = a_ind.float()
    return z
