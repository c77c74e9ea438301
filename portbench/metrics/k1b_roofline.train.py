"""The attention backward's share of its roofline: the least time of the
backward for the shapes of every fused attention forward in the traced
steps (``_FusedAttention``, ``portbench/flops/attention.py``), over the
device time of the kernels launched under the autograd node's range
(``_FusedAttentionBackward``), found by correlation and not by kernel name."""

from portbench.flops import attention

LAYER = "attention backward (ops/attention.py -> csrc/attention_bwd.cu)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "train_samples_per_s"
FORWARD, BACKWARD = "_FusedAttention", "_FusedAttentionBackward"


def read(record):
    tr = record.get("full")
    if tr is None:
        return None
    fwd = tr.ops(FORWARD)
    kernels = tr.launched_under([e for e in tr.host if e["name"].endswith(BACKWARD)
                                 and tr.t0 <= e["ts"] < tr.t1])
    spent = sum(k["dur"] for k in kernels) * 1e-6
    if not fwd or spent <= 0:
        return None
    least = sum(attention.least_seconds(*attention.bwd(*op["args"]["Input Dims"][0]), record["peaks"])
                for op in fwd)
    return 100.0 * least / spent
