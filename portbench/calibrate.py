"""Read the numbers that the correctness check compares, over many seeds in
one process, to set each limit between its two readings:

  * the program against the plain reference (the lower reading);
  * the control: the reference at the next precision below the
    configuration's (fp8 for bf16) in the program's place;
  * for a training cell, the faults a check must catch ("half": half of
    the batch left out; "double": one leaf's update applied twice; for the
    VQ-VAE "ema_skip": the codebook's EMA update left out, "ema_decay": its
    decay swapped with its complement), planted in the reference put in the
    program's place.

    python3 -m portbench.calibrate --workload <cell> --seeds 11,12,… --seconds 3 \\
        [--control 3] [--faults half,double] [--out chiprun_out/calibrate_<cell>.jsonl]

Each seed is set up, run for ``--seconds`` at the cell's own size and load,
and checked as a run checks it. One JSON line per seed."""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import time

from portbench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, default=3, help="read the control on the first N seeds")
    p.add_argument("--faults", default="", help="comma-separated faults, on the control's seeds")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.set_env()
    import torch

    work = harness.load("workloads", args.workload)
    config = harness.load("configs", work["config"])
    traffic = harness.load("traffic", work["traffic"])
    entry = importlib.import_module(f"portbench.entries.{work['entry']}")
    faults = [f for f in args.faults.split(",") if f]
    out = open(args.out, "a") if args.out else None
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        cell = entry.Cell(config, traffic, work, seed, torch.device("cuda"), harness.SetupClock(t))
        cell.window(args.seconds, False)
        cell.free()
        gc.collect()
        torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": seed, "program": cell.check()}
        diag = {"program": getattr(cell, "diag", None)}
        if n < args.control:
            line["control_fp8"] = cell.check(stand_in="fp8")
            diag["control_fp8"] = getattr(cell, "diag", None)
            for f in faults:
                line[f"fault_{f}"] = cell.check(fault=f)
                diag[f"fault_{f}"] = getattr(cell, "diag", None)
        if diag["program"] is not None:
            line["diagnostics"] = diag
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
