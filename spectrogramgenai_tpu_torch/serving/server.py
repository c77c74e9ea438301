"""Dynamic-batching generation server (``spectrogramgenai_tpu/serving/server.py``).

  * ONE sampler call shape: every batch is a fixed label batch
    (``batch_size``), requests pad into it, so each reverse chain costs the
    same and fills the device the same way.
  * A coalescing queue: requests (label, count) become label slots; a worker
    thread drains up to ``batch_size`` slots, waiting at most
    ``max_delay_ms`` once the first slot arrives.
  * Results fan back out to per-request futures; ``GenerationHTTPServer``
    serves them as base64 viridis PNGs, a request's images encoded in one
    call to the native batch encoder (``data/native_png.py``, as the JAX
    server's ``encode_png_batch_rgb``; ``/stats``' ``encode_seconds`` sums
    those calls), and with ``"audio": true`` also as base64 WAVs inverted on
    the task's device (``audio/invert.py``).
  * The worker samples through a task, or through an exported artifact
    (``BatchingSampler.from_artifact``), one seed per batch.
  * Under ``torchrun`` (``cli/serve.py``) rank 0 is the front: it alone
    binds the port and runs the queue, the worker, the PNG encode and the
    audio inversion. The other ranks follow (:class:`RankGroup`): for every
    batch the worker takes, they run the same ``task.sample`` call on the
    same padded labels with a generator seeded alike, so that the labels
    split over the mesh's data axis (and the wide layers over its model
    axis) and the R-rank batch is the one-rank batch. The labels and the
    stop travel over the mesh's control channel, not over NCCL: a follower
    waits there through idle hours. A rank that fails posts its error
    before the rows' gather, so that no rank waits in a gather that will not
    complete; the front's batch then fails, naming the rank, and /healthz
    turns 503.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
import traceback
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np
import torch

from spectrogramgenai_tpu_torch.audio.export import generated_png_bytes
from spectrogramgenai_tpu_torch.audio.invert import AudioReconstructor
from spectrogramgenai_tpu_torch.core.mesh import Mesh

# one wait on the control channel: an idle follower waits again after it, so
# this bounds no idle time, only how long a wait holds a store connection
CONTROL_WAIT_S = 600.0
# the longest one rank may wait for another's status within a batch: the ranks
# run the same chain side by side, so this bounds their lag, not the chain
RANK_LAG_LIMIT_S = 900.0
_STOP = b""  # the op that ends the followers' loop (a batch's labels are never empty)


class RankError(RuntimeError):
    """A rank of the server failed (or missed) a batch."""


def sample_fn(task, *, seed: int, sampler: str, num_steps: int,
              cfg_scale: float | None) -> Callable[[np.ndarray], np.ndarray]:
    """The sampler call of one served batch: labels → (n, H, W, 1) uint8 on
    the host, with a generator on the task's device seeded once from ``seed``
    (every rank of a server makes the same calls in the same order)."""
    generator = torch.Generator(device=task.device).manual_seed(seed)

    def sample(labels: np.ndarray) -> np.ndarray:
        return task.sample(labels, generator=generator, cfg_scale=cfg_scale, sampler=sampler,
                           num_steps=num_steps).cpu().numpy()

    return sample


class RankGroup:
    """The ranks of a server over a mesh, joined by its control channel
    (``Mesh.open_control``). Batch k's keys: ``op/k``, the front's padded
    labels as little-endian int64 (empty: stop), and ``status/k/r``, rank
    r's status: empty once it reaches the rows' gather (``Mesh.check_in``)
    or ends its sample call, else its error. The front deletes batch k's keys
    when batch k + 1 ends, by which time every rank has read them."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.batches = 0  # batches run on this rank, failed ones included: the next op's number
        self._posted = False
        self._lock = threading.Lock()
        mesh.open_control("spectrogramgenai_serve")

    def _others(self) -> list[int]:
        return [r for r in range(self.mesh.world) if r != self.mesh.rank]

    def _post_status(self, error: str = "") -> None:
        self.mesh.post(f"status/{self.batches}/{self.mesh.rank}", error.encode())
        self._posted = True

    def _statuses(self, ranks: list[int], limit_s: float = RANK_LAG_LIMIT_S) -> dict[int, str]:
        """The statuses of ``ranks`` in this batch, once all are posted."""
        keys = [f"status/{self.batches}/{r}" for r in ranks]
        deadline = time.monotonic() + limit_s
        while not self.mesh.wait_posted(keys, max(min(CONTROL_WAIT_S, deadline - time.monotonic()), 1e-3)):
            if time.monotonic() >= deadline:
                raise RankError(f"ranks {ranks} posted no status for batch {self.batches} within {limit_s} s")
        return {r: self.mesh.read_posted(key).decode() for r, key in zip(ranks, keys)}

    def _raise_failed(self, ranks: list[int]) -> None:
        """Raise :class:`RankError` naming each of ``ranks`` that posted an error in this batch."""
        failed = [f"rank {r}: {e}" for r, e in self._statuses(ranks).items() if e]
        if failed:
            raise RankError("; ".join(failed))

    def _check_in(self) -> None:
        """Before the rows' gather: post that this rank got there, and raise
        instead of gathering if another rank failed."""
        self._post_status()
        self._raise_failed(self._others())

    def _run(self, sample, labels: np.ndarray) -> np.ndarray:
        """This rank's sample call of the batch, its status posted."""
        self._posted = False
        self.mesh.check_in = self._check_in
        try:
            out = sample(labels)
        except RankError:  # another rank's failure, seen at the check-in: already posted
            raise
        except Exception as e:
            self._post_status(f"{type(e).__name__}: {e}")
            raise
        finally:
            self.mesh.check_in = None
        if not self._posted:
            self._post_status()
        return out

    def _keys(self, k: int) -> list[str]:
        return [f"op/{k}"] + [f"status/{k}/{r}" for r in range(self.mesh.world)] if k >= 0 else []

    # -- the front (rank 0) -------------------------------------------------------
    def lead(self, sample, labels: np.ndarray) -> np.ndarray:
        """Run one batch on every rank; raises :class:`RankError` naming each
        rank that failed it."""
        with self._lock:
            self.mesh.post(f"op/{self.batches}", np.ascontiguousarray(labels, "<i8").tobytes())
            own = None
            try:
                out = self._run(sample, labels)
            except Exception as e:
                own = e
            try:
                self._raise_failed(self._others())
            finally:
                self.mesh.unpost(self._keys(self.batches - 1))
                self.batches += 1
            if own is not None:
                raise own
            return out

    def stop(self) -> None:
        """Post stop and wait for every follower to take it."""
        with self._lock:
            self.mesh.post(f"op/{self.batches}", _STOP)
            self._statuses(self._others(), limit_s=CONTROL_WAIT_S)
            self.mesh.unpost(self._keys(self.batches - 1) + self._keys(self.batches))

    # -- a follower (every other rank) -----------------------------------------
    def follow(self, sample) -> None:
        """Run every batch the front posts, until it posts stop. A failed
        batch is reported by the front; this rank prints its traceback and
        goes on."""
        while True:
            key = f"op/{self.batches}"
            while not self.mesh.wait_posted([key], CONTROL_WAIT_S):
                pass  # idle: wait again
            op = self.mesh.read_posted(key)
            if op == _STOP:
                self._post_status()
                return
            try:
                self._run(sample, np.frombuffer(op, "<i8").copy())
            except Exception:
                traceback.print_exc()
            self.batches += 1


class _Slot:
    """One requested image: a label index, the future collecting it and when it was submitted."""

    __slots__ = ("label", "future", "results", "want", "submitted")

    def __init__(self, label: int, future: Future, results: list, want: int, submitted: float):
        self.label = label
        self.future = future
        self.results = results  # shared per-request accumulator
        self.want = want
        self.submitted = submitted  # time.monotonic() at submit


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
    ranks : the :class:`RankGroup` of a server over several ranks; this
        sampler is then the front's, and each batch runs on every rank.

    Alternatively construct with ``BatchingSampler.from_artifact(...)`` to
    serve an exported sampler (``serving/export.py``): no task, checkpoint
    or model code involved.
    """

    def __init__(self, task, *, batch_size: int = 27, max_delay_ms: float = 50.0,
                 sampler: str = "dpmpp", num_steps: int = 20, cfg_scale: float | None = None,
                 seed: int = 0, artifact=None, ranks: RankGroup | None = None):
        self.task = task
        self._artifact = artifact
        self._ranks = ranks
        if artifact is not None:  # the artifact froze these at export time
            batch_size = artifact.num_labels
            sampler = artifact.manifest["sampler"]
            num_steps = artifact.manifest["num_steps"]
            cfg_scale = artifact.manifest["cfg_scale"]
            # one seed per batch for the artifact's own generator, drawn from this one
            self._generator = torch.Generator().manual_seed(seed)
        else:
            self._sample = sample_fn(task, seed=seed, sampler=sampler, num_steps=num_steps, cfg_scale=cfg_scale)
        if batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.batch_size = int(batch_size)
        self.max_delay_s = max_delay_ms / 1000.0
        self.sampler = sampler
        self.num_steps = int(num_steps)
        self.cfg_scale = cfg_scale
        self.last_device_error: str | None = None
        self._queue: queue.Queue[_Slot] = queue.Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # queue_wait_seconds: over the served slots, the time from each one's submit to the start of
        # its batch's sampler call, summed; the mean wait of a served image is it over slots_filled
        self.stats = {"requests": 0, "images": 0, "batches": 0,
                      "slots_filled": 0, "slots_padded": 0, "busy_seconds": 0.0,
                      "queue_wait_seconds": 0.0, "encode_seconds": 0.0, "audio_seconds": 0.0}
        self._worker = threading.Thread(target=self._run, name="sampler-worker", daemon=True)
        self._worker.start()

    @classmethod
    def from_artifact(cls, artifact, *, max_delay_ms: float = 50.0, seed: int = 0):
        """Serve a loaded ``ExportedSampler``: the artifact fixes the batch
        size, sampler, steps and CFG scale."""
        return cls(None, artifact=artifact, max_delay_ms=max_delay_ms, seed=seed)

    @property
    def num_classes(self) -> int:
        if self._artifact is not None:
            return self._artifact.manifest["num_classes"]
        return self.task.cfg.num_classes

    @property
    def device(self) -> torch.device:
        return self._artifact.device if self._artifact is not None else self.task.device

    # -- client API -------------------------------------------------------------
    def submit(self, label: int, count: int = 1) -> Future:
        """Request `count` images of class `label`; resolves to (count, H, W, C) uint8."""
        if not (1 <= count <= 1024):
            raise ValueError(f"count out of range: {count}")
        fut: Future = Future()
        results: list = []
        with self._lock:
            self.stats["requests"] += 1
        now = time.monotonic()
        for _ in range(count):
            self._queue.put(_Slot(int(label), fut, results, count, now))
        return fut

    def close(self):
        """Stop the worker and, over several ranks, the followers."""
        self._stop.set()
        self._worker.join(timeout=10)
        if self._ranks is not None:
            self._ranks.stop()

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
                if self._artifact is not None:
                    seed = int(torch.randint(0, 2**31 - 1, (), generator=self._generator))
                    imgs = self._artifact(seed, labels)
                elif self._ranks is not None:
                    imgs = self._ranks.lead(self._sample, labels)
                else:
                    imgs = self._sample(labels)
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
                self.stats["queue_wait_seconds"] += sum(t0 - s.submitted for s in slots)
            for i, s in enumerate(slots):
                s.results.append(imgs[i])
                if len(s.results) == s.want and not s.future.done():
                    s.future.set_result(np.stack(s.results))

    def add_encode_seconds(self, dt: float) -> None:
        """Handler threads report PNG-encode wall time here so /stats splits
        device sampling (busy_seconds) from host response encoding."""
        with self._lock:
            self.stats["encode_seconds"] += dt

    def add_audio_seconds(self, dt: float) -> None:
        """Wall time spent in audio reconstruction (``"audio": true``)."""
        with self._lock:
            self.stats["audio_seconds"] += dt

    def snapshot_stats(self) -> dict:
        with self._lock:
            s = dict(self.stats)
        busy = s.pop("busy_seconds")
        s["busy_seconds"] = round(busy, 3)
        s["queue_wait_seconds"] = round(s["queue_wait_seconds"], 3)
        s["encode_seconds"] = round(s["encode_seconds"], 3)
        s["audio_seconds"] = round(s["audio_seconds"], 3)
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
                        {"label": i, "images": [<base64 png>, ...]};
                        with "audio": true also the waveforms inverted on the
                        device → {..., "audio": [<base64 wav>, ...], "sample_rate": sr}
    """

    def __init__(self, sampler: BatchingSampler, class_names: list[str] | None = None,
                 host: str = "127.0.0.1", port: int = 8000, request_timeout_s: float = 600.0,
                 audio: AudioReconstructor | None = None):
        device = sampler.device
        audio_rec = audio if audio is not None else AudioReconstructor(device=device)
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
                    want_audio = bool(req.get("audio", False))
                except (ValueError, json.JSONDecodeError) as e:
                    return self._json(400, {"error": str(e)})
                try:
                    imgs = sampler.submit(label, count).result(timeout=timeout_s)
                except Exception as e:
                    return self._json(500, {"error": f"{type(e).__name__}: {e}"})
                t_enc = time.monotonic()
                payload = [base64.b64encode(b).decode() for b in generated_png_bytes(imgs)]
                sampler.add_encode_seconds(time.monotonic() - t_enc)
                resp = {"label": label, "images": payload}
                if want_audio:
                    try:
                        t_au = time.monotonic()
                        wavs = audio_rec.wav_bytes_batch(imgs)
                        sampler.add_audio_seconds(time.monotonic() - t_au)
                        resp["audio"] = [base64.b64encode(b).decode() for b in wavs]
                        resp["sample_rate"] = audio_rec.output_sample_rate
                    except Exception as e:
                        return self._json(500, {"error": f"audio: {type(e).__name__}: {e}"})
                self._json(200, resp)

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
