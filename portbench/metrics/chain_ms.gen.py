"""Device time of one sampler chain (``DiffusionTask.sample_latents`` →
``diffusion/ddpm.py``): CUDA events around each chain of the window, all
chains' time over their count."""

LAYER = "sampler chain (diffusion/ddpm.py via DiffusionTask.sample_latents)"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "images_per_s"


def read(record):
    ms = record.get("chain_ms")
    return sum(ms) / len(ms) if ms else None
