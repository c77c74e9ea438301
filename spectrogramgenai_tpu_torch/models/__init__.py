from spectrogramgenai_tpu_torch.models.unet import ConditionalUNet
from spectrogramgenai_tpu_torch.models.vqvae import VQVAE, VQDecoder, VQEmbeddingEMA, VQEncoder

__all__ = ["ConditionalUNet", "VQVAE", "VQEncoder", "VQDecoder", "VQEmbeddingEMA"]
