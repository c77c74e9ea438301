"""UNet building blocks in PyTorch, matching ``spectrogramgenai_tpu/models/layers.py``.

The blocks run NCHW, PyTorch's native convolution layout; the public models
(``unet.py``, ``vqvae.py``) take and return NHWC like the JAX package.
Submodule names repeat the flax module's auto-generated names (``Conv_0``,
``GroupNorm_1``, ``query`` …), so a state_dict key is the flax parameter
path joined with dots and ``bridge.py`` is a path-for-path copy.

flax defaults, not torch's: GELU is the tanh approximation, LayerNorm and
GroupNorm use eps 1e-6, GroupNorm has one group, and the norms compute in
float32 whatever the compute dtype.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from spectrogramgenai_tpu_torch.ops.attention import fused_attention


def sinusoidal_time_embedding(t: torch.Tensor, channels: int, dtype=torch.float32) -> torch.Tensor:
    """(B,) timesteps → (B, channels): [sin(t·f), cos(t·f)], f = 10000^(-2i/channels)."""
    half = channels // 2
    inv_freq = 1.0 / (10000 ** (torch.arange(0, half, dtype=torch.float32, device=t.device) * 2.0 / channels))
    ang = t.float()[:, None] * inv_freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _align_corners_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) linear-interpolation matrix with align_corners=True."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return m
    src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, n_in - 1)
    w = src - lo
    m[np.arange(n_out), lo] += 1.0 - w
    m[np.arange(n_out), hi] += w
    return m


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # cached on the device: the UNet's three Up blocks would otherwise copy
    # two small host matrices to the card on every denoising step. Made
    # outside inference mode, so that training can use a matrix that
    # sampling cached first
    with torch.inference_mode(False):
        return torch.from_numpy(_align_corners_matrix(n_in, n_out)).to(device=device, dtype=dtype)


def upsample_bilinear_align_corners(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """NCHW bilinear ×scale with align_corners=True, as two matmuls."""
    _, _, h, w = x.shape
    ah = _resize_matrix(h, h * scale, x.device, x.dtype)
    aw = _resize_matrix(w, w * scale, x.device, x.dtype)
    x = torch.einsum("Hh,bchw->bcHw", ah, x)
    return torch.einsum("Ww,bchw->bchW", aw, x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm(num_groups=1)`` over NCHW."""

    def __init__(self, channels: int):
        super().__init__(1, channels, eps=1e-6)

    def forward(self, x):
        return F.group_norm(x.float(), 1, self.weight.float(), self.bias.float(), self.eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` over the last axis."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class DoubleConv(nn.Module):
    """Conv→GroupNorm(1)→GELU→Conv→GroupNorm(1) [+ residual GELU], bias-free convs."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: int | None = None,
                 residual: bool = False):
        super().__init__()
        mid = mid_channels or out_channels
        self.residual = residual
        self.Conv_0 = nn.Conv2d(in_channels, mid, 3, padding=1, bias=False)
        self.GroupNorm_0 = GroupNorm(mid)
        self.Conv_1 = nn.Conv2d(mid, out_channels, 3, padding=1, bias=False)
        self.GroupNorm_1 = GroupNorm(out_channels)

    def forward(self, x):
        y = gelu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        return gelu(x + y) if self.residual else y


class SpatialSelfAttention(nn.Module):
    """Token self-attention over the H×W grid.

    LN → 4-head MHA → +residual → (LN→Dense→GELU→Dense) → +residual.
    With ``fused=True`` the attention core of a site with ``N >= 1024`` and
    ``N % 256 == 0`` tokens goes through :func:`ops.attention.fused_attention`;
    shorter sites take the plain matmul/softmax path, as in the JAX package.
    """

    def __init__(self, channels: int, num_heads: int = 4, fused: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = channels // num_heads
        self.fused = fused
        inner = num_heads * self.head_dim
        self.LayerNorm_0 = LayerNorm(channels)
        self.query = nn.Linear(channels, inner)
        self.key = nn.Linear(channels, inner)
        self.value = nn.Linear(channels, inner)
        self.out = nn.Linear(inner, channels)
        self.LayerNorm_1 = LayerNorm(channels)
        self.Dense_0 = nn.Linear(channels, channels)
        self.Dense_1 = nn.Linear(channels, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        n, heads, hd = h * w, self.num_heads, self.head_dim
        tokens = x.flatten(2).transpose(1, 2)  # (B, N, C)
        ln = self.LayerNorm_0(tokens)
        q = self.query(ln).view(b, n, heads, hd)
        k = self.key(ln).view(b, n, heads, hd)
        v = self.value(ln).view(b, n, heads, hd)

        if self.fused and n >= 1024 and n % 256 == 0:
            ctx = fused_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous()).transpose(1, 2)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        tokens = tokens + self.out(ctx.reshape(b, n, heads * hd))
        tokens = tokens + self.Dense_1(gelu(self.Dense_0(self.LayerNorm_1(tokens))))
        return tokens.transpose(1, 2).reshape(b, c, h, w)


class TimeEmbedProject(nn.Module):
    """SiLU→Dense projection of the time embedding, broadcast-added."""

    def __init__(self, time_dim: int, out_channels: int):
        super().__init__()
        self.Dense_0 = nn.Linear(time_dim, out_channels)

    def forward(self, x, t_emb):
        return x + self.Dense_0(F.silu(t_emb))[:, :, None, None]


class Down(nn.Module):
    """maxpool2 → DoubleConv(residual) → DoubleConv → +time."""

    def __init__(self, in_channels: int, out_channels: int, time_dim: int = 256):
        super().__init__()
        self.DoubleConv_0 = DoubleConv(in_channels, in_channels, residual=True)
        self.DoubleConv_1 = DoubleConv(in_channels, out_channels)
        self.TimeEmbedProject_0 = TimeEmbedProject(time_dim, out_channels)

    def forward(self, x, t_emb):
        x = F.max_pool2d(x, 2)
        x = self.DoubleConv_1(self.DoubleConv_0(x))
        return self.TimeEmbedProject_0(x, t_emb)


class Up(nn.Module):
    """bilinear↑2 (align corners) → concat skip → convs → +time."""

    def __init__(self, in_channels: int, out_channels: int, time_dim: int = 256):
        super().__init__()  # in_channels: AFTER the concat
        self.DoubleConv_0 = DoubleConv(in_channels, in_channels, residual=True)
        self.DoubleConv_1 = DoubleConv(in_channels, out_channels, mid_channels=in_channels // 2)
        self.TimeEmbedProject_0 = TimeEmbedProject(time_dim, out_channels)

    def forward(self, x, skip, t_emb):
        x = torch.cat([skip, upsample_bilinear_align_corners(x, 2)], dim=1)
        x = self.DoubleConv_1(self.DoubleConv_0(x))
        return self.TimeEmbedProject_0(x, t_emb)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init of every conv, dense, embedding and norm layer, in
    the spirit of flax's defaults: kernels normal(0, 1/√fan_in), biases 0,
    norm scales 1, embeddings normal(0, 1/√features)."""

    def normal_(t: torch.Tensor, std: float):
        t.copy_(torch.randn(t.shape, generator=generator, dtype=torch.float32) * std)

    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            normal_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
        elif isinstance(m, nn.ConvTranspose2d):  # weight (in, out, kh, kw)
            normal_(m.weight, 1.0 / math.sqrt(m.weight.shape[0] * m.weight[0, 0].numel()))
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 1.0 / math.sqrt(m.embedding_dim))
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
        else:
            continue
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()
    return module
