from spectrogramgenai_tpu_torch.ops.attention import (
    attention_bwd_reference,
    attention_reference,
    fused_attention,
    fused_attention_bwd,
    fused_attention_residuals,
)

__all__ = ["attention_reference", "attention_bwd_reference", "fused_attention", "fused_attention_bwd",
           "fused_attention_residuals"]
