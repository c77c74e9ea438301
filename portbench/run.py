"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file (``portbench/workloads/<cell>.json``) names its
configuration (``portbench/configs/<config>.json``), its entry
(``portbench/entries/<entry>.py``), its traffic and the limits of its
correctness check. ``--trace 0`` reports the cell's end-to-end metrics;
``--trace 1`` profiles a steady part of the window and reports the
per-layer metrics that ``BENCHMARK.json`` gives this cell, each read by
``portbench/metrics/<metric>.py``. The
last line of standard output is one JSON object; the last lines of standard
error give each number compared beside its limit. A run without the CUDA
devices the cell asks for exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import math
import sys
import time

T_START = time.perf_counter()

from portbench import harness  # noqa: E402


def run_cell(workload_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             workload: dict | None = None, config: dict | None = None, traffic: dict | None = None, t0: float = T_START) -> tuple[dict, dict]:
    """Set up, measure and check one cell; returns (result, checks). The
    cell, configuration and traffic dicts may be given instead of read by name."""
    import torch

    workload = workload or harness.load("workloads", workload_name)
    config = config or harness.load("configs", workload["config"])
    traffic = traffic or harness.load("traffic", workload["traffic"])
    clock = harness.SetupClock(t0)
    entry = importlib.import_module(f"portbench.entries.{workload['entry']}")  # imports the program
    clock.parts["import"] = clock.total()
    cell = entry.Cell(config, traffic, workload, seed, torch.device(device), clock)
    setup_s = clock.total()
    harness.log("setup", {k: round(v, 4) for k, v in clock.parts.items()}, "total", round(setup_s, 4))
    out = cell.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    cell.free()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.check()
    correct, checks = harness.judge(numbers, workload["limits"])
    harness.log("readings not compared:", {k: v for k, v in numbers.items() if k not in checks})
    correct = correct and out["failed_checked"] == 0
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": workload["chips"], "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        tr, full = out["record"]["trace"], out["record"]["full"]
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": full.idle_gaps()}
        metrics, readers = {}, harness.metric_modules()
        for m in harness.per_layer_for(workload_name, workload["end_to_end"]):
            value = readers[m["name"]].read(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=setup_s)
        metrics = {name: {"value": values[name], "unit": unit} for name, unit in workload["end_to_end"].items()}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": dev, "breakdown": breakdown, "checks": checks}
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.set_env()
    workload = harness.load("workloads", args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        harness.log(f"needs {workload['chips']} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), workload=workload)
    found = harness.forbidden_modules()
    if found:
        harness.log("loaded, and forbidden in a run:", ", ".join(found))
        return 3
    for name, c in checks.items():
        harness.log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    if result["breakdown"] is None:
        del result["breakdown"]
    for c in checks.values():  # a number that is not finite is written as null
        if not math.isfinite(c["value"]):
            c["value"] = None
    print(harness.result_line(**result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
