"""spectrogramgenai_tpu_torch — the PyTorch/CUDA port of spectrogramgenai_tpu.

Same subpackages and module names as the JAX package, so each module's
counterpart is found by its path. This slice carries the serving path:
class-conditional latent DDPM (UNet + VQ-VAE), the DDPM / DDIM /
DPM-Solver++ samplers, the dynamic-batching HTTP server and the generate
CLI. The self-attention forward runs in a hand-written CUDA kernel
(``csrc/attention_fwd.cu``) on the card; on a CPU tensor the same wrapper
computes its plain PyTorch version. Imports torch, never JAX.
"""

__version__ = "0.1.0"
