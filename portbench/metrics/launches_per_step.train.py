"""Kernel launches per optimizer step: the kernels in the trace of the
device alone over the steps it covers (a count; what host dispatch has to
issue)."""

LAYER = "host dispatch (train/common.py, train/*_task.py)"
UNIT = "launches/step"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "train_samples_per_s"


def read(record):
    tr = record.get("trace")
    if tr is None:
        return None
    return len(tr.kernels_in_window()) / record["traced_steps"]
