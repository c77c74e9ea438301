from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
