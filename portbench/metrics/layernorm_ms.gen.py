"""Device time of a chain's LayerNorms (``models/layers.py`` ``LayerNorm``,
its float32 casts included): the kernels launched under the program's
``sgai.norm.layer`` spans in the traced chain, whatever kernels implement
the norm, found by correlation and not by kernel name, over the count of
its ``sgai.sample.chain`` spans."""

from portbench import spans

LAYER = "LayerNorm with its float32 casts (models/layers.py LayerNorm)"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "images_per_s"


def read(record):
    return spans.device_ms_per(record, "sgai.norm.layer", "sgai.sample.chain")
