"""Conditional diffusion UNet in PyTorch, matching ``spectrogramgenai_tpu/models/unet.py``.

64→128→256→256 encoder with self-attention after every resolution change,
a 256→512→512→256 bottleneck (``remove_deep_conv`` drops the 512 pair),
three Up blocks with skip concats, a sinusoidal time embedding and class
conditioning added into it. Classifier-free guidance uses a per-sample
``cond_mask``, so the sampler runs the conditional and unconditional halves
as one 2n batch.

Input and output are NHWC like the JAX model; the blocks run NCHW inside.
The compute dtype is the dtype the module was cast to (``.to(torch.bfloat16)``);
the output is float32 either way.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from spectrogramgenai_tpu_torch.models.layers import (
    DoubleConv,
    Down,
    SpatialSelfAttention,
    Up,
    init_weights_,
    sinusoidal_time_embedding,
)


class ConditionalUNet(nn.Module):
    """Diffusion UNet; ``num_classes=None`` for the unconditional variant."""

    def __init__(self, c_in: int = 1, c_out: int = 1, time_dim: int = 256,
                 num_classes: int | None = 27, remove_deep_conv: bool = False,
                 width_mult: float = 1.0, fused_attention: bool = False):
        super().__init__()
        self.time_dim = time_dim
        self.num_classes = num_classes

        def w(c: int) -> int:
            return max(8, int(c * width_mult))

        def sa(channels: int) -> SpatialSelfAttention:
            return SpatialSelfAttention(channels, fused=fused_attention)

        self.DoubleConv_0 = DoubleConv(c_in, w(64))
        self.Down_0 = Down(w(64), w(128), time_dim)
        self.sa_0 = sa(w(128))
        self.Down_1 = Down(w(128), w(256), time_dim)
        self.sa_1 = sa(w(256))
        self.Down_2 = Down(w(256), w(256), time_dim)
        self.sa_2 = sa(w(256))
        if remove_deep_conv:
            deep = [DoubleConv(w(256), w(256)), DoubleConv(w(256), w(256))]
        else:
            deep = [DoubleConv(w(256), w(512)), DoubleConv(w(512), w(512)), DoubleConv(w(512), w(256))]
        for i, block in enumerate(deep, start=1):
            self.add_module(f"DoubleConv_{i}", block)
        self.deep = [f"DoubleConv_{i}" for i in range(1, len(deep) + 1)]
        self.Up_0 = Up(w(512), w(128), time_dim)
        self.sa_3 = sa(w(128))
        self.Up_1 = Up(w(256), w(64), time_dim)
        self.sa_4 = sa(w(64))
        self.Up_2 = Up(w(128), w(64), time_dim)
        self.sa_5 = sa(w(64))
        self.outc = nn.Conv2d(w(64), c_out, 1)
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, time_dim)

    def reset_parameters(self, generator: torch.Generator) -> ConditionalUNet:
        return init_weights_(self, generator)

    def forward(self, x, t, y=None, cond_mask=None):
        """x (B, H, W, C), t (B,) → ε prediction (B, H, W, c_out) float32."""
        dt = self.outc.weight.dtype
        t_emb = sinusoidal_time_embedding(t, self.time_dim, dtype=dt)
        if self.num_classes is not None:
            if y is None:
                y = torch.zeros((x.shape[0],), dtype=torch.long, device=x.device)
                cond_mask = torch.zeros((x.shape[0],), device=x.device)
            lab = self.label_emb(y)
            if cond_mask is not None:
                lab = lab * cond_mask.to(lab.dtype)[:, None]
            t_emb = t_emb + lab

        x = x.to(dt).permute(0, 3, 1, 2)
        x1 = self.DoubleConv_0(x)
        x2 = self.sa_0(self.Down_0(x1, t_emb))
        x3 = self.sa_1(self.Down_1(x2, t_emb))
        x4 = self.sa_2(self.Down_2(x3, t_emb))
        for name in self.deep:
            x4 = getattr(self, name)(x4)
        xu = self.sa_3(self.Up_0(x4, x3, t_emb))
        xu = self.sa_4(self.Up_1(xu, x2, t_emb))
        xu = self.sa_5(self.Up_2(xu, x1, t_emb))
        return self.outc(xu).float().permute(0, 2, 3, 1)
