"""Serving: the port's HTTP server (``serving/server.py``:
``GenerationHTTPServer`` over ``BatchingSampler`` over ``DiffusionTask``)
under open-loop traffic from a client process (``traffic/client.py``).

``latency_p95_ms`` is the 95th percentile over every request due in the
window, each timed from its due time until its PNG response has been read;
a request that fails, or has no answer within the time limit after the
window, counts in ``failed`` with the time it was waited for.

The check: a sample of the responses, drawn from the seed, is decoded
(PNG → viridis → gray), found among the batches the sampler ran (the
proxy task below records each batch's padded labels and its images), and
compared with the plain reference's image for that batch's row: the same
x_T, which is the batch's draw from a device generator seeded as the
server's, and the same label."""

from __future__ import annotations

import base64
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from spectrogramgenai_tpu_torch.core.config import DDPMConfig
from spectrogramgenai_tpu_torch.ops import _build
from spectrogramgenai_tpu_torch.serving.server import BatchingSampler, GenerationHTTPServer
from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask

from portbench import harness, trace
from portbench.entries import common
from portbench.reference import compare, sampler
from portbench.traffic import client, generator

CLIENT = [sys.executable, "-m", "portbench.traffic.client"]


class RecordingTask:
    """The task as the server sees it: ``sample`` is ``DiffusionTask.sample``
    on one card (the chain, then the decode), recording each batch's labels,
    images and latents. The copy of the images to the host that the server
    makes is made here; the latents' copy follows it, so it waits for
    nothing."""

    def __init__(self, task):
        self.task, self.device, self.cfg = task, task.device, task.cfg
        self.batches: list[tuple[np.ndarray, np.ndarray, torch.Tensor]] = []

    def sample(self, labels, **kw):
        x = self.task.sample_latents(labels, **kw)
        host = self.task.decode(x).cpu()
        self.batches.append((np.array(labels, np.int64), host.numpy(), x.cpu()))
        return host


class Cell:
    def __init__(self, config: dict, traffic: dict, workload: dict, seed: int, device: torch.device,
                 clock: harness.SetupClock):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        classes = config["num_classes"]
        with clock.part("extensions"):
            _build.build(["attention_fwd", "png_batch"] if device.type == "cuda" else ["png_batch"])
        with clock.part("weights"):
            self.P = common.unet_weights(config, seed, device)
            self.V = common.vq_weights(config, seed, device)
        with clock.part("program"):
            task = DiffusionTask(common.task_config(DDPMConfig, config), device, vq_params=self.V)
            task.load_params(self.P)
            self.proxy = RecordingTask(task)
            self.server_seed = generator.subseed(seed, "server")
            self.sampler = BatchingSampler(self.proxy, batch_size=traffic["serve_batch"],
                                           max_delay_ms=traffic["max_delay_ms"], sampler=traffic["sampler"],
                                           num_steps=traffic["num_steps"], seed=self.server_seed)
            self.server = GenerationHTTPServer(self.sampler, host="127.0.0.1", port=0)
            self.server.start()
        with clock.part("client"):  # the client process starts while the server warms up
            self.client = self.spawn_client()
        with clock.part("warmup"):  # one full batch, and its PNGs
            n = traffic["serve_batch"]
            warm = client.run_schedule({"host": "127.0.0.1", "port": self.server.port, "offsets": [0.0] * n,
                                        "labels": [i % classes for i in range(n)], "keep": [],
                                        "limit_after_s": traffic["limit_after_s"]})
            if not all(r["ok"] for r in warm):
                raise RuntimeError(f"warm-up requests failed: {[r.get('error') for r in warm if not r['ok']][:3]}")

    @staticmethod
    def spawn_client() -> subprocess.Popen:
        return subprocess.Popen(CLIENT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=harness.ROOT,
                                env=dict(os.environ, PYTHONPATH=str(harness.ROOT)))

    def window(self, seconds: float, tracing: bool) -> dict:
        tr_cfg = self.traffic
        offsets, labels = generator.arrivals(tr_cfg, seconds, self.config["num_classes"], self.seed)
        n = len(offsets)
        self.labels = labels
        self.keep = sorted(generator.rng(self.seed, "checked").choice(n, min(tr_cfg["checked"], n), replace=False)
                           .tolist())
        spec = {"host": "127.0.0.1", "port": self.server.port, "offsets": offsets.tolist(),
                "labels": labels.tolist(), "keep": self.keep, "limit_after_s": tr_cfg["limit_after_s"]}
        self.client.stdin.write(json.dumps(spec) + "\n")
        self.client.stdin.flush()
        if tracing:
            trace.warm_profiler()
        before = dict(self.sampler.stats)
        self.client.stdin.write("go\n")
        self.client.stdin.flush()
        t0 = time.perf_counter()
        traced = {k: 0 for k in before}
        if tracing:  # the device alone, for a while inside the window: a trace of the host's ops
            # in this many-threaded process has crashed the profiler
            time.sleep(max(0.0, t0 + tr_cfg["traced_from_s"] - time.perf_counter()))
            prof = trace.Profiler(host=False)
            at_start = dict(self.sampler.stats)
            prof.start()
            time.sleep(tr_cfg["traced_s"])
            prof.stop()
            traced = {k: self.sampler.stats[k] - at_start[k] for k in before}
        out, _ = self.client.communicate(timeout=seconds + tr_cfg["limit_after_s"] + 60)
        self.results = json.loads(out.strip().splitlines()[-1])
        after = dict(self.sampler.stats)
        # the server's counters over the window less the traced stretch, whose
        # profiler slows the batches it covers
        stats = {k: after[k] - before[k] - traced[k] for k in before}
        ok = [r for r in self.results if r["ok"]]
        lat = [r["latency_s"] for r in self.results]
        late = [r["late_s"] for r in self.results if "late_s" in r]
        harness.log(f"requests {n}, answered {len(ok)}, sender lateness max {max(late, default=0):.4f} s "
                    f"mean {np.mean(late) if late else 0:.5f} s")
        record = {"stats": stats, "requests": n}
        if tracing:  # the idle gaps are named by the CUDA calls of the thread that launched most kernels
            record["trace"] = record["full"] = prof.read()
        return {"end_to_end": {"latency_p95_ms": 1e3 * harness.percentile(lat, 95)}, "attempted": n,
                "failed": n - len(ok), "failed_checked": sum(not self.results[i]["ok"] for i in self.keep),
                "record": record}

    def free(self) -> None:
        if self.client.poll() is None:
            self.client.kill()
            self.client.wait()
        self.server.shutdown()
        self.sampler.close()
        self.batches = self.proxy.batches
        del self.proxy, self.sampler, self.server

    def _located(self) -> list[tuple[int, int, np.ndarray]]:
        """(batch, row) of each kept response; batch −1 where its colours are
        those of no image of a batch under its label."""
        out = []
        for i in self.keep:
            r = self.results[i]
            if not r["ok"]:
                continue
            rgb = compare.png_rgb(base64.b64decode(r["png_b64"]))
            label = int(self.labels[i])
            found = [(k, j) for k, (lab, imgs, _) in enumerate(self.batches)
                     for j in np.flatnonzero(lab == label) if np.array_equal(compare.VIRIDIS[imgs[j, ..., 0]], rgb)]
            out.append(found[0] if found else (-1, -1))
        return out

    def check(self, stand_in: str | None = None) -> dict[str, float]:
        """Each kept response's batch row: its latents against the plain
        reference's chain from the same x_T and label, and its image (the
        served PNG's, which is that row's image) against the reference's
        decode of those latents, as the generation cell judges them."""
        located = self._located()
        if any(k < 0 for k, _ in located):
            return {"latent_gap": float("inf"), "decode_gap": float("inf")}
        size = self.config["img_size"] // self.config["latent_downscale"]
        shape = (self.traffic["serve_batch"], size, size, self.config["latent_dim"])
        g = torch.Generator(device=self.device).manual_seed(self.server_seed)
        draws = [torch.randn(shape, generator=g, device=self.device)
                 for _ in range(max(k for k, _ in located) + 1)]  # batch k's x_T is the generator's k-th draw
        lat, dec = [], []
        steps = self.traffic["num_steps"]
        with common.reference_mode():
            for k in sorted({k for k, _ in located}):
                rows = [j for kk, j in located if kk == k]
                labels_k, images_k, latents_k = self.batches[k]
                labels = torch.as_tensor(labels_k[rows], device=self.device)
                ref = sampler.dpmpp_chain(self.P, self.config, draws[k][rows], labels, steps)
                x = latents_k[rows].to(self.device)
                served = torch.as_tensor(images_k[rows])
                if stand_in is not None:
                    x = sampler.dpmpp_chain(self.P, self.config, draws[k][rows], labels, steps, stand_in)
                    served = sampler.decode_uint8(self.V, x, stand_in)
                lat.append(compare.latent_gap(x, ref))
                dec.append(compare.image_gap(served, sampler.decode_uint8(self.V, x)))
        return {"latent_gap": max(lat), "decode_gap": max(dec)}
