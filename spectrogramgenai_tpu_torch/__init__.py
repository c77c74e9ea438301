"""spectrogramgenai_tpu_torch — the PyTorch/CUDA port of spectrogramgenai_tpu.

Same subpackages and module names as the JAX package, so each module's
counterpart is found by its path. Ported so far: the serving path
(class-conditional latent DDPM, the DDPM / DDIM / DPM-Solver++ samplers, the
dynamic-batching HTTP server, the generate CLI), the wav → log-mel front end
(gen_specs), latent-DDPM training (train_ddpm), VQ-VAE training
(train_vqvae), and the classifier zoo, sweep and evaluation
(train_classifiers, eval_classifiers). The self-attention
forward and backward and the mel power spectrogram run in hand-written CUDA
kernels (``csrc/``) on the card; on a CPU tensor each wrapper computes its
plain PyTorch version. Imports torch, never JAX.
"""

__version__ = "0.1.0"
