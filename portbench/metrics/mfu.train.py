"""The whole training step's share of the chip's bf16 peak: the step's
FLOPs counted from the shapes (``portbench/flops``: forward and backward as
three forwards, the VQ-VAE's codebook distances once), times the window's
whole steps, over the host time they took (the time of
``train_samples_per_s``)."""

LAYER = "model step, training (models/unet.py; models/vqvae.py)"
UNIT = "%"
SOURCE = "host_clock"
BETTER = "higher"
MOVES = "train_samples_per_s"


def read(record):
    return 100.0 * record["window_flops"] / record["window_s"] / record["peaks"]["bf16_flops_per_s"]
