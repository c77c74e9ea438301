"""Find the serving cell's knee: the highest offered rate at which the
backlog does not grow over a window. One server is set up (as the cell's
run sets it up) and offered each rate in turn for ``--seconds``, from a
fresh client process; a rate holds when every request is answered and the
median latency of the window's last quarter of requests (by due time) is
within 1.2 times that of its first quarter.

    python3 -m portbench.sweep --workload serve_ldm27_b54_open --seed <n> --rates 40,50,60 --seconds 20
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from portbench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    harness.set_env()
    import torch

    from portbench.entries import serve

    work = harness.load("workloads", args.workload)
    config = harness.load("configs", work["config"])
    traffic = harness.load("traffic", work["traffic"])
    cell = serve.Cell(config, traffic, work, args.seed, torch.device("cuda"), harness.SetupClock(time.perf_counter()))
    cell.client.kill()
    cell.client.wait()
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic = dict(traffic, rate_per_s=rate)
        cell.client = cell.spawn_client()
        time.sleep(2.0)  # the client's imports, outside the window
        out = cell.window(args.seconds, False)
        lat = np.array([r["latency_s"] for r in cell.results])
        q = max(1, len(lat) // 4)
        first, last = float(np.median(lat[:q])), float(np.median(lat[-q:]))
        stats = out["record"]["stats"]
        line = {"rate_per_s": rate, "requests": out["attempted"], "failed": out["failed"],
                "latency_p50_ms": 1e3 * float(np.median(lat)),
                "latency_p95_ms": out["end_to_end"]["latency_p95_ms"], "first_quarter_p50_ms": 1e3 * first,
                "last_quarter_p50_ms": 1e3 * last, "batches": stats["batches"],
                "occupancy": stats["slots_filled"] / max(1, stats["slots_filled"] + stats["slots_padded"]),
                "busy_ms": 1e3 * stats["busy_seconds"] / max(1, stats["batches"]),
                "holds": out["failed"] == 0 and last <= 1.2 * first}
        print(json.dumps(line), flush=True)
    cell.free()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
