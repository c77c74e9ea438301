"""The whole generation step's share of the chip's bf16 peak: the chain's
FLOPs counted from the shapes (``portbench/flops``: the UNet at both CFG
halves for every step, the quantise and the VQ decode), times the window's
whole chains, over the host time they took (the time of ``images_per_s``)."""

LAYER = "model step (models/unet.py, models/layers.py, models/vqvae.py)"
UNIT = "%"
SOURCE = "host_clock"
BETTER = "higher"
MOVES = "images_per_s"


def read(record):
    return 100.0 * record["window_flops"] / record["window_s"] / record["peaks"]["bf16_flops_per_s"]
