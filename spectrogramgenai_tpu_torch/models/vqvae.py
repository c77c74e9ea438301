"""VQ-VAE in PyTorch, matching ``spectrogramgenai_tpu/models/vqvae.py`` (inference half).

Encoder: two stride-2 convs (k=4), two residual convs (k=3, 1), 1×1 projection
to a 4-channel latent at H/4 × W/4. Codebook: nearest entry by squared
euclidean distance. Decoder: mirror of the encoder with stride-2 transposed
convs (k=2). The codebook (``embedding``, ``ema_count``, ``ema_weight``) is
held in float32 buffers; the EMA update and the losses are training and are
not here yet.

``encode`` and ``decode_quantized`` take and return NHWC like the JAX model.
Cast ``encoder`` and ``decoder`` to a compute dtype to run them in it; the
codebook search stays float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from spectrogramgenai_tpu_torch.models.layers import init_weights_


class VQEncoder(nn.Module):
    def __init__(self, input_dim: int = 1, hidden_dim: int = 512, latent_dim: int = 4):
        super().__init__()
        self.Conv_0 = nn.Conv2d(input_dim, hidden_dim, 4, stride=2, padding=1)
        self.Conv_1 = nn.Conv2d(hidden_dim, hidden_dim, 4, stride=2, padding=1)
        self.Conv_2 = nn.Conv2d(hidden_dim, hidden_dim, 3, padding=1)
        self.Conv_3 = nn.Conv2d(hidden_dim, hidden_dim, 1)
        self.Conv_4 = nn.Conv2d(hidden_dim, latent_dim, 1)

    def forward(self, x):
        """NCHW image → NCHW float32 latent."""
        x = x.to(self.Conv_0.weight.dtype)
        x = F.relu(self.Conv_1(self.Conv_0(x)))
        x = F.relu(self.Conv_2(x) + x)
        y = self.Conv_3(x) + x
        return self.Conv_4(y).float()


class VQDecoder(nn.Module):
    def __init__(self, hidden_dim: int = 512, output_dim: int = 1, latent_dim: int = 4):
        super().__init__()
        self.Conv_0 = nn.Conv2d(latent_dim, hidden_dim, 1)
        self.Conv_1 = nn.Conv2d(hidden_dim, hidden_dim, 1)
        self.Conv_2 = nn.Conv2d(hidden_dim, hidden_dim, 3, padding=1)
        self.ConvTranspose_0 = nn.ConvTranspose2d(hidden_dim, hidden_dim, 2, stride=2)
        self.ConvTranspose_1 = nn.ConvTranspose2d(hidden_dim, output_dim, 2, stride=2)

    def forward(self, z):
        """NCHW latent → NCHW float32 image."""
        x = self.Conv_0(z.to(self.Conv_0.weight.dtype))
        x = F.relu(self.Conv_1(x) + x)
        y = F.relu(self.Conv_2(x) + x)
        return self.ConvTranspose_1(self.ConvTranspose_0(y)).float()


class VQEmbeddingEMA(nn.Module):
    """The codebook: nearest-entry quantization (EMA update not ported yet)."""

    def __init__(self, n_embeddings: int = 512, embedding_dim: int = 4):
        super().__init__()
        self.register_buffer("embedding", torch.zeros(n_embeddings, embedding_dim))
        self.register_buffer("ema_count", torch.zeros(n_embeddings))
        self.register_buffer("ema_weight", torch.zeros(n_embeddings, embedding_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax init: embedding ~ U(-1/M, 1/M), ema_count 0, ema_weight = embedding."""
        m, d = self.embedding.shape
        emb = (torch.rand((m, d), generator=generator) * 2.0 - 1.0) / m
        self.embedding.copy_(emb)
        self.ema_count.zero_()
        self.ema_weight.copy_(emb)

    def _nearest(self, x_flat: torch.Tensor) -> torch.Tensor:
        emb = self.embedding
        d2 = (x_flat.pow(2).sum(1, keepdim=True) - 2.0 * x_flat @ emb.T
              + emb.pow(2).sum(1)[None, :])
        return torch.argmin(d2, dim=-1)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, D) → (quantized (B, H, W, D), indices (B, H, W))."""
        b, h, w, d = x.shape
        idx = self._nearest(x.float().reshape(-1, d))
        return self.embedding[idx].reshape(b, h, w, d), idx.reshape(b, h, w)

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        return self.embedding[indices]


class VQVAE(nn.Module):
    """encode → quantize → decode."""

    def __init__(self, input_dim: int = 1, hidden_dim: int = 512, latent_dim: int = 4,
                 n_embeddings: int = 512, output_dim: int = 1):
        super().__init__()
        self.encoder = VQEncoder(input_dim, hidden_dim, latent_dim)
        self.codebook = VQEmbeddingEMA(n_embeddings, latent_dim)
        self.decoder = VQDecoder(hidden_dim, output_dim, latent_dim)

    def reset_parameters(self, generator: torch.Generator) -> VQVAE:
        init_weights_(self, generator)
        self.codebook.reset_parameters(generator)
        return self

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image → unquantized NHWC latent (the latent-diffusion training input)."""
        return self.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def decode_quantized(self, z: torch.Tensor) -> torch.Tensor:
        """NHWC latent → quantize → decode → NHWC image (the sampling tail)."""
        q, _ = self.codebook.encode(z)
        return self.decoder(q.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
