"""Device time of a chain's GroupNorms (``models/layers.py`` ``GroupNorm``,
its float32 casts included): the kernels launched under the program's
``sgai.norm.group`` spans in the traced chain, whatever kernels implement
the norm, found by correlation and not by kernel name, over the count of
its ``sgai.sample.chain`` spans."""

from portbench import spans

LAYER = "GroupNorm with its float32 casts (models/layers.py GroupNorm)"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "images_per_s"


def read(record):
    return spans.device_ms_per(record, "sgai.norm.group", "sgai.sample.chain")
