from spectrogramgenai_tpu_torch.diffusion.ddpm import (
    DiffusionSchedule,
    ddim_sample,
    ddpm_sample,
    diffusion_loss,
    dpmpp_sample,
    linear_schedule,
    q_sample,
    to_uint8,
)

__all__ = ["DiffusionSchedule", "linear_schedule", "q_sample", "diffusion_loss", "ddpm_sample",
           "ddim_sample", "dpmpp_sample", "to_uint8"]
