"""VQ-VAE in PyTorch, matching ``spectrogramgenai_tpu/models/vqvae.py``.

Encoder: two stride-2 convs (k=4), two residual convs (k=3, 1), 1×1 projection
to a 4-channel latent at H/4 × W/4. Codebook (``VQEmbeddingEMA``): nearest
entry by squared euclidean distance; in train mode an EMA update of the
entry counts (with Laplace smoothing) and of the summed latents assigned to
each entry, and embedding = weight / count, all in float32; the
straight-through output, the commitment loss β·mean‖z − sg(z_q)‖², the
codebook loss and the perplexity. Decoder: mirror of the encoder with
stride-2 transposed convs (k=2). The codebook (``embedding``,
``ema_count``, ``ema_weight``) is held in float32 buffers, which the train
forward updates in place.

The public methods take and return NHWC like the JAX model. Cast
``encoder`` and ``decoder`` to a compute dtype to run them in it; the
codebook stays float32.
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
    """The EMA-updated codebook."""

    def __init__(self, n_embeddings: int = 512, embedding_dim: int = 4, commitment_cost: float = 0.25,
                 decay: float = 0.999, epsilon: float = 1e-5):
        super().__init__()
        self.commitment_cost, self.decay, self.epsilon = commitment_cost, decay, epsilon
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

    def forward(self, x: torch.Tensor, train: bool = False):
        """(B, H, W, D) float32 latent → (straight-through quantized, commitment
        loss, codebook loss, perplexity). The search runs against the codebook
        as it was before this call's update."""
        m, d = self.embedding.shape
        x_flat = x.detach().reshape(-1, d)
        idx = self._nearest(x_flat)
        # one-hot by comparison: F.one_hot checks the indices' range on the host, a sync each step
        encodings = (idx[:, None] == torch.arange(m, device=idx.device)).float()
        quantized = self.embedding[idx].reshape(x.shape)
        if train:
            with torch.no_grad():
                ema_count = self.decay * self.ema_count + (1.0 - self.decay) * encodings.sum(0)
                n = ema_count.sum()
                ema_count = (ema_count + self.epsilon) / (n + m * self.epsilon) * n
                ema_weight = self.decay * self.ema_weight + (1.0 - self.decay) * (encodings.T @ x_flat)
                self.ema_count.copy_(ema_count)
                self.ema_weight.copy_(ema_weight)
                self.embedding.copy_(ema_weight / ema_count[:, None])
        codebook_loss = (x.detach() - quantized).square().mean()
        commitment_loss = self.commitment_cost * (x - quantized).square().mean()  # quantized holds no grad
        quantized_st = x + (quantized - x).detach()
        avg_probs = encodings.mean(0)
        perplexity = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-10)).sum())
        return quantized_st, commitment_loss, codebook_loss, perplexity


class VQVAE(nn.Module):
    """encode → quantize → decode."""

    def __init__(self, input_dim: int = 1, hidden_dim: int = 512, latent_dim: int = 4,
                 n_embeddings: int = 512, output_dim: int = 1, commitment_cost: float = 0.25,
                 ema_decay: float = 0.999, ema_eps: float = 1e-5):
        super().__init__()
        self.encoder = VQEncoder(input_dim, hidden_dim, latent_dim)
        self.codebook = VQEmbeddingEMA(n_embeddings, latent_dim, commitment_cost, ema_decay, ema_eps)
        self.decoder = VQDecoder(hidden_dim, output_dim, latent_dim)

    def reset_parameters(self, generator: torch.Generator) -> VQVAE:
        init_weights_(self, generator)
        self.codebook.reset_parameters(generator)
        return self

    def forward(self, x: torch.Tensor, train: bool = False):
        """NHWC image → (x_hat, z, z_q, commitment loss, codebook loss,
        perplexity), NHWC float32; in train mode the codebook is updated."""
        z = self.encode(x)
        z_q, commitment_loss, codebook_loss, perplexity = self.codebook(z, train=train)
        x_hat = self.decoder(z_q.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return x_hat, z, z_q, commitment_loss, codebook_loss, perplexity

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image → unquantized NHWC latent (the latent-diffusion training input)."""
        return self.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def decode_quantized(self, z: torch.Tensor) -> torch.Tensor:
        """NHWC latent → quantize → decode → NHWC image (the sampling tail)."""
        q, _ = self.codebook.encode(z)
        return self.decoder(q.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
