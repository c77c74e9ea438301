"""Operations of the VQ-VAE, counted from its widths: convolutions and
transposed convolutions (2·Cin·Cout·k² per output position of a
convolution, per input position of a transposed one) and the codebook's
distance product (2·M·D per latent position)."""

from __future__ import annotations


def encode(hidden: int, latent: int, size: int) -> float:
    """FLOPs of one (size, size, 1) image through the encoder."""
    h2, h4 = (size // 2) ** 2, (size // 4) ** 2
    return 2.0 * (1 * hidden * 16 * h2 + hidden * hidden * 16 * h4 + hidden * hidden * 9 * h4
                  + hidden * hidden * h4 + hidden * latent * h4)


def decode(hidden: int, latent: int, size: int) -> float:
    """FLOPs of one (size/4, size/4, latent) latent through the decoder."""
    h4, h2 = (size // 4) ** 2, (size // 2) ** 2
    return 2.0 * (latent * hidden * h4 + hidden * hidden * h4 + hidden * hidden * 9 * h4
                  + hidden * hidden * 4 * h4 + hidden * 1 * 4 * h2)


def quantise(latent: int, codes: int, size: int) -> float:
    return 2.0 * codes * latent * (size // 4) ** 2
