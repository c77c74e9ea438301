"""Device time of one optimizer update (``train/common.py``
``optimizer_update``: the optimizer's step and the working copy's refresh):
the kernels launched under the program's ``sgai.train.optimizer`` spans in
the traced steps, found by correlation and not by kernel name, over the
count of its ``sgai.train.step`` spans."""

from portbench import spans

LAYER = "optimizer update (train/common.py optimizer_update)"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "train_samples_per_s"


def read(record):
    return spans.device_ms_per(record, "sgai.train.optimizer", "sgai.train.step")
