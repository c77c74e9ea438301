"""The share of the traced window in which no operation ran on the device
(the window minus the union of kernel, copy and set intervals), from a
trace of the device alone, which costs the host little."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "train_samples_per_s"


def read(record):
    tr = record.get("trace")
    return tr.idle_pct() if tr is not None else None
