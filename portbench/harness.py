"""What every cell's run shares: the fixed cache directories, the cell,
configuration and metric files found by name, the set-up clock, the check
that nothing of JAX was loaded, and the result line."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "spectrogramgenai_tpu")
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def set_env() -> None:
    """Every build and kernel cache of the program in fixed directories
    inside the checkout; keep libraries from loading flax or JAX."""
    os.environ["SPECTROGRAMGENAI_TORCH_BUILD_DIR"] = str(CACHE / "build")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is one of :data:`FORBIDDEN`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def load(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``, e.g. ``load("workloads", "gen_ldm27_dpmpp20_b108")``."""
    if not NAME_RE.match(name):
        raise ValueError(f"bad name {name!r}")
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def spec() -> dict:
    """``BENCHMARK.json``, at the root of the checkout."""
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def per_layer_for(cell: str, end_to_end, per_layer: list[dict] | None = None) -> list[dict]:
    """The per-layer metrics (of ``BENCHMARK.json`` unless given) that ``cell``
    reports: those that list it under ``workloads``, or, without that key,
    those that move one of the cell's ``end_to_end`` metrics."""
    per_layer = spec()["per_layer"] if per_layer is None else per_layer
    return [m for m in per_layer
            if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in end_to_end)]


def metric_modules() -> dict:
    """Every per-layer metric reader under ``portbench/metrics``, by its name."""
    out = {}
    for path in sorted((BENCH / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


class SetupClock:
    """Wall seconds of set-up, from the start of the process's own code, in named parts."""

    def __init__(self, t0: float):
        self.t0, self.parts = t0, {}

    @contextlib.contextmanager
    def part(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t

    def total(self) -> float:
        return time.perf_counter() - self.t0


def peaks() -> dict:
    """The chip's published peaks (``portbench/peaks.json``)."""
    with open(BENCH / "peaks.json") as f:
        return json.load(f)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) with linear interpolation between order statistics."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """Each number that the cell's limits name beside its limit (the others
    are readings only); correct when each of them is finite and within its limit."""
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    ok = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)
