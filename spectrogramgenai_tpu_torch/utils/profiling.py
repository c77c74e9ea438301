"""Profiling hooks (``spectrogramgenai_tpu/utils/profiling.py``): a
``torch.profiler`` trace written as a Chrome trace, and the port's named
spans inside it.

A span is a ``torch.profiler.record_function`` range named
``sgai.<layer>.<what>``. It records only while a profiler session records
(``trace`` below, or any other session a caller opens), in that session,
on its clock, beside the device kernels launched inside it; its parent is
the enclosing range on the same thread. With no session recording, and
while ``torch.compile`` or ``torch.export`` traces, a span is one shared
context that does nothing, so an exported program holds no profiler op.

    sgai.train.step       one optimizer step of a task's ``train_step``
    sgai.train.optimizer  ``train/common.optimizer_update``: the gradient
                          reduction under a mesh, the optimizer's step and
                          the working copy's refresh from the masters
    sgai.train.ema        ``core/ema.ema_update``
    sgai.sample.chain     ``DiffusionTask.sample_latents``: one reverse chain
    sgai.norm.group       ``models/layers.GroupNorm``, its float32 casts included
    sgai.norm.layer       ``models/layers.LayerNorm``, its float32 casts included
"""

from __future__ import annotations

import contextlib
import os

import torch

TRACE_FILE = "trace.json"
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range called ``name`` while a profiler session
    records, else the shared context that does nothing."""
    if not torch.autograd._profiler_enabled() or torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Trace the CPU and, where there is a card, the CUDA kernels of what
    runs inside into ``<log_dir>/trace.json`` (open it in Perfetto or
    chrome://tracing), the spans above included; under ``torchrun`` rank
    r > 0 writes ``trace_rank<r>.json``. No ``log_dir``: nothing is traced."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    rank = int(os.environ.get("RANK", 0))
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE if rank == 0 else f"trace_rank{rank}.json"))
