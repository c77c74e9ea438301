"""Dynamic-batching generation server (``spectrogramgenai_tpu/serving/server.py``).

  * ONE sampler call shape: every batch is a fixed label batch
    (``batch_size``), requests pad into it, so each reverse chain costs the
    same and fills the device the same way.
  * A coalescing queue: requests (label, count) become label slots; a worker
    thread drains up to ``batch_size`` slots, waiting at most
    ``max_delay_ms`` once the first slot arrives.
  * Results fan back out to per-request futures; ``GenerationHTTPServer``
    serves them as base64 viridis PNGs.

Audio reconstruction is not ported yet: a request with ``"audio": true``
gets a 501.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from spectrogramgenai_tpu_torch.audio.export import generated_png_bytes


class _Slot:
    """One requested image: a label index and the future collecting it."""

    __slots__ = ("label", "future", "results", "want")

    def __init__(self, label: int, future: Future, results: list, want: int):
        self.label = label
        self.future = future
        self.results = results  # shared per-request accumulator
        self.want = want


class BatchingSampler:
    """Coalesce concurrent generation requests into fixed-shape sampler calls.

    Parameters
    ----------
    task : a DiffusionTask with its weights loaded.
    batch_size : label batch per chain; requests pad into it.
    max_delay_ms : max time the worker waits to fill a batch after the
        first request arrives (the latency/throughput knob).
    sampler, num_steps, cfg_scale : forwarded to task.sample.
    seed : seeds the worker's generator on the task's device.
    """

    def __init__(self, task, *, batch_size: int = 27, max_delay_ms: float = 50.0,
                 sampler: str = "dpmpp", num_steps: int = 20, cfg_scale: float | None = None,
                 seed: int = 0):
        if batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.task = task
        self.batch_size = int(batch_size)
        self.max_delay_s = max_delay_ms / 1000.0
        self.sampler = sampler
        self.num_steps = int(num_steps)
        self.cfg_scale = cfg_scale
        self.last_device_error: str | None = None
        self._generator = torch.Generator(device=task.device).manual_seed(seed)
        self._queue: queue.Queue[_Slot] = queue.Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "images": 0, "batches": 0,
                      "slots_filled": 0, "slots_padded": 0, "busy_seconds": 0.0,
                      "encode_seconds": 0.0}
        self._worker = threading.Thread(target=self._run, name="sampler-worker", daemon=True)
        self._worker.start()

    @property
    def num_classes(self) -> int:
        return self.task.cfg.num_classes

    @property
    def device(self) -> torch.device:
        return self.task.device

    # -- client API -------------------------------------------------------------
    def submit(self, label: int, count: int = 1) -> Future:
        """Request `count` images of class `label`; resolves to (count, H, W, C) uint8."""
        if not (1 <= count <= 1024):
            raise ValueError(f"count out of range: {count}")
        fut: Future = Future()
        results: list = []
        with self._lock:
            self.stats["requests"] += 1
        for _ in range(count):
            self._queue.put(_Slot(int(label), fut, results, count))
        return fut

    def close(self):
        self._stop.set()
        self._worker.join(timeout=10)

    # -- worker -----------------------------------------------------------------
    def _take_batch(self) -> list[_Slot]:
        """Block for the first slot, then fill greedily until batch_size or
        max_delay_ms elapses."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        slots = [first]
        deadline = time.monotonic() + self.max_delay_s
        while len(slots) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                slots.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return slots

    def _run(self):
        while not self._stop.is_set():
            slots = self._take_batch()
            if not slots:
                continue
            labels = np.zeros((self.batch_size,), np.int64)  # pad slots sample class 0, discarded
            labels[: len(slots)] = [s.label for s in slots]
            t0 = time.monotonic()
            try:
                imgs = self.task.sample(labels, generator=self._generator, cfg_scale=self.cfg_scale,
                                        sampler=self.sampler, num_steps=self.num_steps).cpu().numpy()
            except Exception as e:  # surface device failures to every waiting client
                self.last_device_error = f"{type(e).__name__}: {e}"
                for s in slots:
                    if not s.future.done():
                        s.future.set_exception(e)
                continue
            dt = time.monotonic() - t0
            with self._lock:
                self.stats["batches"] += 1
                self.stats["slots_filled"] += len(slots)
                self.stats["slots_padded"] += self.batch_size - len(slots)
                self.stats["images"] += len(slots)
                self.stats["busy_seconds"] += dt
            for i, s in enumerate(slots):
                s.results.append(imgs[i])
                if len(s.results) == s.want and not s.future.done():
                    s.future.set_result(np.stack(s.results))

    def add_encode_seconds(self, dt: float) -> None:
        """Handler threads report PNG-encode wall time here so /stats splits
        device sampling (busy_seconds) from host response encoding."""
        with self._lock:
            self.stats["encode_seconds"] += dt

    def snapshot_stats(self) -> dict:
        with self._lock:
            s = dict(self.stats)
        busy = s.pop("busy_seconds")
        s["busy_seconds"] = round(busy, 3)
        s["encode_seconds"] = round(s["encode_seconds"], 3)
        if busy > 0:
            s["images_per_sec_busy"] = round(s["images"] / busy, 3)
        if s["batches"] > 0:
            s["mean_occupancy"] = round(s["slots_filled"] / (s["batches"] * self.batch_size), 3)
        return s


class GenerationHTTPServer:
    """Minimal HTTP front end over a BatchingSampler.

    Endpoints:
      GET  /healthz   → {"ok": true, "backend": "cuda", "device": "cuda:0", "classes": N}
                        (503 with "device_error" once a batch failed on the device)
      GET  /stats     → batching/throughput counters
      POST /generate  → {"label": int|str, "count": int} →
                        {"label": i, "images": [<base64 png>, ...]}
    """

    def __init__(self, sampler: BatchingSampler, class_names: list[str] | None = None,
                 host: str = "127.0.0.1", port: int = 8000, request_timeout_s: float = 600.0):
        device = sampler.device
        names = class_names or []
        name_to_idx = {n: i for i, n in enumerate(names)}
        num_classes = sampler.num_classes
        timeout_s = request_timeout_s

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default; stats endpoint instead
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    # a device failure is not recoverable in-process: report
                    # unhealthy so a supervisor can restart or drain us
                    err = sampler.last_device_error
                    self._json(200 if err is None else 503,
                               {"ok": err is None, "backend": device.type, "device": str(device),
                                "classes": num_classes,
                                **({"device_error": err} if err else {})})
                elif self.path == "/stats":
                    self._json(200, sampler.snapshot_stats())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/generate":
                    return self._json(404, {"error": "not found"})
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    label = req.get("label", 0)
                    if isinstance(label, str):
                        if label not in name_to_idx:
                            return self._json(400, {"error": f"unknown class {label!r}"})
                        label = name_to_idx[label]
                    label = int(label)
                    if not (0 <= label < num_classes):
                        return self._json(400, {"error": f"label out of range: {label}"})
                    count = int(req.get("count", 1))
                    if not (1 <= count <= 256):
                        return self._json(400, {"error": f"count out of range: {count}"})
                    if req.get("audio", False):
                        return self._json(501, {"error": "audio reconstruction is not ported "
                                                         "to the PyTorch package yet"})
                except (ValueError, json.JSONDecodeError) as e:
                    return self._json(400, {"error": str(e)})
                try:
                    imgs = sampler.submit(label, count).result(timeout=timeout_s)
                except Exception as e:
                    return self._json(500, {"error": f"{type(e).__name__}: {e}"})
                t_enc = time.monotonic()
                payload = [base64.b64encode(b).decode() for b in generated_png_bytes(imgs)]
                sampler.add_encode_seconds(time.monotonic() - t_enc)
                self._json(200, {"label": label, "images": payload})

        # a deeper accept backlog than the default 5: bursts of concurrent
        # clients otherwise overflow it and the kernel resets connections
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128
            daemon_threads = True

        self._httpd = _Server((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="http-server", daemon=True)
        self._thread.start()

    def serve_forever(self):
        self._httpd.serve_forever()

    def shutdown(self):
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._httpd.server_close()
