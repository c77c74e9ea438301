"""The attention forward's share of its roofline: the least time for the
shapes of every call of the operator ``spectrogramgenai_tpu_torch::attention_fwd``
in the traced chain (``portbench/flops/attention.py``: the larger of
operations over the bf16 peak and bytes over the memory bandwidth), over
the device time of the kernels launched under the operator's range, found
by correlation and not by kernel name."""

from portbench.flops import attention

LAYER = "attention forward (ops/attention.py -> csrc/attention_fwd.cu)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "images_per_s"
OP = "spectrogramgenai_tpu_torch::attention_fwd"


def read(record):
    tr = record.get("full")
    ops = tr.ops(OP) if tr is not None else []
    kernels = tr.launched_under(ops) if ops else []
    spent = sum(k["dur"] for k in kernels) * 1e-6
    if not kernels or spent <= 0:
        return None
    least = sum(attention.least_seconds(*attention.fwd(*op["args"]["Input Dims"][0]), record["peaks"])
                for op in ops)
    return 100.0 * least / spent
