"""The transformer spectrogram denoiser in PyTorch, matching ``spectrogramgenai_tpu/models/denoiser.py``.

A 5-conv stride-2 encoder (256² → 8² × d_model), a post-norm transformer
encoder (d_model 512, 8 heads, FFN 2048, ReLU, dropout 0.1) over the 64
spatial tokens, and a 5-stage transposed-conv decoder back to
``out_channels`` with tanh. As residual noise reduction it is applied as
``x ← renorm(x − net(x))`` before the classifiers; as the separator it
predicts the (noise, bird) pair with ``out_channels=2``.

flax's layers, not torch's:
  * the attention is flax ``MultiHeadDotProductAttention``: separate
    query / key / value / out projections (the bridge reshapes their
    (d, h, d/h) and (h, d/h, d) kernels), q scaled by 1/√(d/h), the softmax
    in float32, plain tensor ops (the JAX package computes it in XLA, not in
    its attention kernel, and so does the port);
  * LayerNorm has eps 1e-6 (``layers.LayerNorm``);
  * ``ConvTranspose(3×3, stride 2, padding="SAME")`` is torch's
    ``conv_transpose2d`` with no padding and the kernel flipped in space
    (the bridge flips it), cropped to the first 2n rows and columns;
  * dropout keeps an element with probability 0.9 and scales it by 1/0.9,
    with keep masks from a ``classifiers.DropoutKeep`` by the Dropout's path
    (``TransformerEncoderLayer_0.Dropout_0`` …).

The model takes and returns NHWC like the JAX one and runs NCHW inside;
the output is float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from spectrogramgenai_tpu_torch.models.classifiers import Dropout, DropoutKeep
from spectrogramgenai_tpu_torch.models.layers import LayerNorm


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, d_model // num_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h, d = self.num_heads, self.head_dim
        q = self.query(x).view(b, n, h, d) / math.sqrt(d)
        k = self.key(x).view(b, n, h, d)
        v = self.value(x).view(b, n, h, d)
        probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k).float(), dim=-1).to(q.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(ctx.reshape(b, n, h * d))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (torch TransformerEncoderLayer's defaults, flax's layers)."""

    def __init__(self, d_model: int = 512, num_heads: int = 8, d_ff: int = 2048, dropout: float = 0.1,
                 name: str = "TransformerEncoderLayer_0"):
        super().__init__()
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(d_model, num_heads)
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Dense_0 = nn.Linear(d_model, d_ff)
        self.Dense_1 = nn.Linear(d_ff, d_model)
        self.LayerNorm_1 = LayerNorm(d_model)
        self.drop = nn.ModuleList(Dropout(dropout, f"{name}.Dropout_{i}") for i in range(3))

    def forward(self, x: torch.Tensor, keep: DropoutKeep | None = None) -> torch.Tensor:
        attn = self.drop[0](self.MultiHeadDotProductAttention_0(x), keep)
        x = self.LayerNorm_0(x + attn)
        y = self.drop[1](F.relu(self.Dense_0(x)), keep)
        y = self.drop[2](self.Dense_1(y), keep)
        return self.LayerNorm_1(x + y)


class ConvTranspose2dSame(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(k×k, stride s, padding="SAME")`` (weights from the bridge, flipped)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 2):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        s = self.stride[0]
        return super().forward(x)[..., : s * h, : s * w]


class TransformerDenoiser(nn.Module):
    """(B, H, W, 1) → (B, H, W, out_channels) float32 in [-1, 1]."""

    ENCODER = ((32, 3), (64, 1), (128, 1), (256, 1))  # (features, padding); then d_model, padding 0
    DECODER = (256, 128, 64, 32)

    def __init__(self, out_channels: int = 1, num_layers: int = 6, d_model: int = 512):
        super().__init__()
        self.num_layers = num_layers
        in_c = 1
        for i, (feats, pad) in enumerate(self.ENCODER):
            setattr(self, f"Conv_{i}", nn.Conv2d(in_c, feats, 3, stride=2, padding=pad))
            in_c = feats
        self.Conv_4 = nn.Conv2d(in_c, d_model, 3, stride=2, padding=0)
        for i in range(num_layers):
            setattr(self, f"TransformerEncoderLayer_{i}",
                    TransformerEncoderLayer(d_model, name=f"TransformerEncoderLayer_{i}"))
        in_c = d_model
        for i, feats in enumerate(self.DECODER):
            setattr(self, f"ConvTranspose_{i}", ConvTranspose2dSame(in_c, feats))
            in_c = feats
        self.ConvTranspose_4 = ConvTranspose2dSame(in_c, out_channels)

    def forward(self, x: torch.Tensor, keep: DropoutKeep | None = None) -> torch.Tensor:
        """``keep`` None: eval (no dropout); else train-mode dropout with its masks."""
        x = x.permute(0, 3, 1, 2).to(self.Conv_0.weight.dtype)
        for i in range(5):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        b, c, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)  # (B, h·w, C), row-major over (h, w) as flax reshapes NHWC
        for i in range(self.num_layers):
            tokens = getattr(self, f"TransformerEncoderLayer_{i}")(tokens, keep)
        x = tokens.transpose(1, 2).reshape(b, c, h, w)
        for i in range(4):
            x = F.relu(getattr(self, f"ConvTranspose_{i}")(x))
        x = self.ConvTranspose_4(x)
        return torch.tanh(x).permute(0, 2, 3, 1).float()
