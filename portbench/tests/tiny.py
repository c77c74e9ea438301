"""The cells at a size a CPU test can run: every width cut, the program in
float32, where it matches the plain reference to rounding; the cells'
limits as their files set them."""

from __future__ import annotations

import time

from portbench import harness, run

LDM = dict(width_mult=0.125, img_size=32, vq_hidden_dim=16, time_dim=32, compute_dtype="float32")
VQ = dict(img_size=32, hidden_dim=16, compute_dtype="float32")
TRAFFIC = {
    "closed_loop_chains": dict(rounds=1, num_steps=3, check_within=3),
    "train_steps": dict(corpus=64, batch=8, epochs_drawn=4),
    "open_loop_requests": dict(serve_batch=6, num_steps=3, rate_per_s=8.0, limit_after_s=30.0, checked=4),
}


def cell(name: str) -> tuple[dict, dict, dict]:
    work = harness.load("workloads", name)
    config = harness.load("configs", work["config"])
    config = dict(config, **(LDM if work["config"] == "ldm27" else VQ))
    traffic = harness.load("traffic", work["traffic"])
    return work, config, dict(traffic, **TRAFFIC[traffic["kind"]])


def run_tiny(name: str, seed: int = 2**31 + 17, seconds: float = 1.5) -> dict:
    """One run of the cell on the CPU at the tiny size, past the look for a chip."""
    work, config, traffic = cell(name)
    result, _ = run.run_cell(name, seed, seconds, False, device="cpu", workload=work, config=config,
                             traffic=traffic, t0=time.perf_counter())
    return result
