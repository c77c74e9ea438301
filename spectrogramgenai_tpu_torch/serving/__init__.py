"""Serving layer: dynamic-batching spectrogram generation service."""

from spectrogramgenai_tpu_torch.serving.server import BatchingSampler, GenerationHTTPServer, RankError, RankGroup

__all__ = ["BatchingSampler", "GenerationHTTPServer", "RankError", "RankGroup"]
