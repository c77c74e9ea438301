"""spectrogramgenai_tpu_torch — the PyTorch/CUDA port of spectrogramgenai_tpu.

Same subpackages and module names as the JAX package, so each module's
counterpart is found by its path. Ported so far: the serving path
(class-conditional latent DDPM, the DDPM / DDIM / DPM-Solver++ samplers, the
dynamic-batching HTTP server, the generate CLI), the wav → log-mel front end
(gen_specs), latent-DDPM training (train_ddpm), VQ-VAE training
(train_vqvae), the classifier zoo, sweep and evaluation
(train_classifiers, eval_classifiers), spectrogram → audio inversion
(spec_to_wav, generate --audio_dir, the server's WAVs), the ACGAN and
the SpecUNet denoiser/separator (train_acgan, train_specunet), and the
evaluators: InceptionV3 IS and FID (inception_score, fid), the CLAP audio
tower and FAD (fad), verify_metrics, with converted flax weights read by
core/flax_msgpack; the ACGAN's manifest mode, the trajectory dump
(generate --sav_denoise_path), train_ddpm --profile_dir and utils/misc; and
sampler export (export_model, generate --artifact, serve --artifact:
``torch.export`` programs in a zip, serving/export.py). The self-attention
forward and backward and the mel power spectrogram run in hand-written CUDA
kernels (``csrc/*.cu``) on the card; on a CPU tensor each wrapper computes
its plain PyTorch version. The attention forward is also the ``torch.library``
operator ``spectrogramgenai_tpu_torch::attention_fwd``, which exported
programs call. The host's WAV decoder and PNG
codec are C++ thread pools (``csrc/*.cpp``, built with g++ at first use).
Imports torch, never JAX.
"""

__version__ = "0.1.0"
