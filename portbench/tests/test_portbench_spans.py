"""The readers of the program's spans (``optimizer_ms.train``, ``ema_ms.train``,
``groupnorm_ms.gen``, ``layernorm_ms.gen``) on hand-built traces, and the
spans as a CPU profiler's Chrome trace of the port holds them."""

import json
import os
import tempfile

import pytest
import torch

from portbench import harness
from portbench.trace import WINDOW, Trace

READERS = harness.metric_modules()
# each reader: its span and the span it is counted per
SPANS = {"optimizer_ms.train": ("sgai.train.optimizer", "sgai.train.step"),
         "ema_ms.train": ("sgai.train.ema", "sgai.train.step"),
         "groupnorm_ms.gen": ("sgai.norm.group", "sgai.sample.chain"),
         "layernorm_ms.gen": ("sgai.norm.layer", "sgai.sample.chain")}
MAIN, AUTOGRAD = 1, 2


def _range(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _launched(ts, dur, corr, tid=MAIN, name="elementwise_kernel"):
    """A kernel of ``dur`` µs and its launch at ``ts`` on thread ``tid``."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2, "tid": tid,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "ts": ts + 5, "dur": dur, "tid": 7,
             "args": {"correlation": corr}}]


def _trace(span, per, base=2):
    """``base`` ``per`` ranges, each holding two ``span`` ranges that each
    launch kernels of 30 and 12 µs; the same kernel launched outside the
    spans, and one inside a span's time on another thread, are not theirs."""
    events = [_range(WINDOW, 0, 20_000)]
    for i in range(base):
        t = 1000 + 4000 * i
        events += [_range(per, t, 3000)]
        events += _launched(t + 100, 400, 100 * i + 1)  # before the spans, inside the base
        for j, s in enumerate((t + 1000, t + 2000)):
            c = 100 * i + 10 * j
            events += [_range(span, s, 500)]
            events += _launched(s + 50, 30, c + 2) + _launched(s + 200, 12, c + 3)
            events += _launched(s + 100, 250, c + 4, tid=AUTOGRAD)
    events += _launched(19_000, 800, 9999)  # after every range
    return Trace(events)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_reader_sums_the_device_time_under_its_span_over_the_base_count(name):
    span, per = SPANS[name]
    for base in (1, 3):
        assert READERS[name].read({"full": _trace(span, per, base)}) == pytest.approx(2 * (30 + 12) * 1e-3)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_reader_is_none_where_its_span_or_base_is_missing(name):
    span, per = SPANS[name]
    assert READERS[name].read({"full": _trace("sgai.other", per)}) is None
    assert READERS[name].read({"full": _trace(span, "sgai.other")}) is None
    assert READERS[name].read({}) is None


def test_spans_of_a_cpu_train_step_reach_the_trace_and_read_none_without_device_time():
    from torch.profiler import ProfilerActivity, profile, record_function

    from spectrogramgenai_tpu_torch.core.config import VQVAEConfig
    from spectrogramgenai_tpu_torch.train.vqvae_task import VQVAETask

    task = VQVAETask(VQVAEConfig(hidden_dim=8, n_embeddings=8, compute_dtype="float32"), "cpu")
    state = task.init_state(0)
    x = torch.rand((2, 16, 16, 1), generator=torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof, record_function(WINDOW):
        for _ in range(2):
            task.train_step(state, x)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            tr = Trace(json.load(f)["traceEvents"])
    finally:
        os.remove(path)
    assert len(tr.ops("sgai.train.step")) == len(tr.ops("sgai.train.optimizer")) == 2
    assert tr.ops("sgai.train.ema") == []
    assert READERS["optimizer_ms.train"].read({"full": tr}) is None  # no kernels on the CPU: None, never 0
