from spectrogramgenai_tpu_torch.ops.attention import attention_reference, fused_attention

__all__ = ["attention_reference", "fused_attention"]
