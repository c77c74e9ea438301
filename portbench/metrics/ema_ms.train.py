"""Device time of one EMA update of the weights (``core/ema.py``
``ema_update``, called by ``DiffusionTask.train_step``): the kernels
launched under the program's ``sgai.train.ema`` spans in the traced steps,
found by correlation and not by kernel name, over the count of its
``sgai.train.step`` spans."""

from portbench import spans

LAYER = "weight EMA (core/ema.py via DiffusionTask.train_step)"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "train_samples_per_s"


def read(record):
    return spans.device_ms_per(record, "sgai.train.ema", "sgai.train.step")
