"""Reading a ``torch.profiler`` trace (Chrome trace JSON): device intervals,
the union of device busy time inside the traced window, kernel time by
name, the kernels launched under a host op's range (by correlation id, not
by kernel name), the host op that was running in each idle gap, and the
shapes that a host op was called with."""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
WINDOW = "portbench.window"


class Trace:
    def __init__(self, events: list[dict]):
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"]
        win = [e for e in self.host if e["name"] == WINDOW]
        if win:
            self.t0, self.t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        else:  # a trace of the device alone: from the first CUDA call or device op to the last one's end
            span = self.device + [e for e in self.host if e["cat"] in ("cuda_runtime", "cuda_driver")]
            self.t0 = min(e["ts"] for e in span)
            self.t1 = max(e["ts"] + e["dur"] for e in span)
        self._launch = {}
        for e in self.host:
            if e["cat"] in ("cuda_runtime", "cuda_driver") and "Launch" in e["name"]:
                self._launch.setdefault(e["tid"], []).append(e)
        for v in self._launch.values():
            v.sort(key=lambda e: e["ts"])
        self._launch_ts = {tid: [e["ts"] for e in v] for tid, v in self._launch.items()}
        self._by_corr = {e.get("args", {}).get("correlation"): e for e in self.kernels}

    # -- the window ----------------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of device intervals, clipped to the window (µs)."""
        spans = sorted((max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1)) for e in self.device)
        out: list[list[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernels_in_window(self) -> list[dict]:
        return [e for e in self.kernels if self.t0 <= e["ts"] < self.t1]

    # -- by name -------------------------------------------------------------------
    def top_device_ops(self, k: int = 10) -> list[list]:
        total = collections.Counter()
        for e in self.device:
            if self.t0 <= e["ts"] < self.t1:
                total[e["name"]] += e["dur"] * 1e-6
        return [[name, sec] for name, sec in total.most_common(k)]

    def ops(self, name: str) -> list[dict]:
        """The host events (ops or ranges) called ``name``, inside the window."""
        return [e for e in self.host if e["name"] == name and self.t0 <= e["ts"] < self.t1]

    def launched_under(self, ranges: list[dict]) -> list[dict]:
        """The device kernels whose launches fall inside any of these host
        ranges, on the range's own thread, each once."""
        out = {}
        for r in ranges:
            launches = self._launch.get(r["tid"], [])
            i = bisect.bisect_left(self._launch_ts.get(r["tid"], []), r["ts"])
            while i < len(launches) and launches[i]["ts"] <= r["ts"] + r["dur"]:
                k = self._by_corr.get(launches[i].get("args", {}).get("correlation"))
                if k is not None:
                    out[id(k)] = k
                i += 1
        return list(out.values())

    # -- idle gaps -----------------------------------------------------------------
    def idle_gaps(self, k: int = 10) -> list[list]:
        """The longest gaps with no device work, each named by the innermost
        portbench range and the innermost other host event open at the gap's
        start on the thread that launched most kernels."""
        busy = self.busy_intervals()
        gaps, prev = [], self.t0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = b
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        counts = collections.Counter(e["tid"] for v in self._launch.values() for e in v)
        tid = counts.most_common(1)[0][0] if counts else None
        mine = [e for e in self.host if e["tid"] == tid or e["name"].startswith("portbench.")]
        out = []
        for a, b in gaps[:k]:
            open_ = [e for e in mine if e["ts"] <= a < e["ts"] + e["dur"] and e["name"] != WINDOW]
            pb = [e for e in open_ if e["name"].startswith("portbench.")]
            other = [e for e in open_ if not e["name"].startswith("portbench.")]
            inner = lambda es: max(es, key=lambda e: e["ts"])["name"] if es else None  # noqa: E731
            out.append([f"{inner(pb) or 'no portbench range'} / {inner(other) or 'no host op'}", (b - a) * 1e-6])
        return out


class Profiler:
    """``torch.profiler`` from :meth:`start` to :meth:`stop`, which ends in a
    synchronise; :meth:`read` exports and parses the trace later, outside the
    measured work. With ``host=False`` only the device and the CUDA calls are
    traced, which costs the host little: the device's busy and idle time come
    from such a trace. With ``host=True`` the host's ops too, with their
    input shapes, inside a ``portbench.window`` range: the kernels under an
    op and the host op of each idle gap come from such a trace, whose gaps
    the tracing itself widens."""

    def __init__(self, host: bool):
        self.host = host

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if self.host else [ProfilerActivity.CUDA]
        self.prof = profile(activities=acts, record_shapes=self.host)
        self.prof.__enter__()
        self.range = record_function(WINDOW) if self.host else None
        if self.range is not None:
            self.range.__enter__()

    def stop(self) -> None:
        """Stop, and write the trace out at once: the next profiler's start clears its events."""
        torch.cuda.synchronize()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, self.path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(self.path)

    def read(self) -> Trace:
        try:
            with open(self.path) as f:
                return Trace(json.load(f)["traceEvents"])
        finally:
            os.remove(self.path)


def warm_profiler() -> None:
    """The first profiler of a process spends seconds setting up its CUDA
    tracing: spend them here, outside any traced window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
