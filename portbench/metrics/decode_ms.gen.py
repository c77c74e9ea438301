"""Device time of one chain's VQ decode (``DiffusionTask.decode`` →
``models/vqvae.py``): CUDA events around each decode of the window, all
decodes' time over their count."""

LAYER = "VQ decode (models/vqvae.py via DiffusionTask.decode)"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "images_per_s"


def read(record):
    ms = record.get("decode_ms")
    return sum(ms) / len(ms) if ms else None
