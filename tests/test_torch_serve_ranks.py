"""Serving over several gloo ranks: ``cli.serve`` under torchrun's
environment, rank 0 the HTTP front, the other ranks following it over the
mesh's control channel.

A tiny pixel-space DDPM (16×16, width 0.125, DDIM 4 steps, float32) with
weights from the JAX package's converter. Each group of ranks is started
once (``tests/torch_serve_worker.py``, one process a rank) and answers a
fixed sequence of requests, posted one after another; the one-rank server
(``cli.serve.run`` in this process, the same checkpoint and seed) answers
the same sequence, batch for batch. The 2-rank ``DiffusionTask.sample`` is
also held to the JAX task's on a 2-device CPU mesh.
"""

import base64
import contextlib
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectrogramgenai_tpu.core import config as jc  # noqa: E402
from spectrogramgenai_tpu.core.mesh import MeshSpec, create_mesh  # noqa: E402
from spectrogramgenai_tpu.train.diffusion_task import DiffusionTask as JaxTask  # noqa: E402
from spectrogramgenai_tpu_torch.audio.export import VIRIDIS_LUT, decode_png_rgb  # noqa: E402
from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from spectrogramgenai_tpu_torch.core import config as tc  # noqa: E402
from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from spectrogramgenai_tpu_torch.models.unet import ConditionalUNet  # noqa: E402
from torch_port_helpers import REPO, one_torch_thread, random_flax_variables, spawn_ranks  # noqa: E402, F401

CFG = dict(img_size=16, latent=False, num_classes=5, noise_steps=50, width_mult=0.125, remove_deep_conv=True,
           compute_dtype="float32")
RUN = dict(run_name="tiny", seed=3)
FLAGS = ["--device", "cpu", "--sampler", "ddim", "--num_steps", "4", "--port", "0", "--max_delay_ms", "50",
         "--run.run_name", RUN["run_name"], "--run.seed", str(RUN["seed"]),
         *[f"--{k}={str(v).lower() if isinstance(v, bool) else v}" for k, v in CFG.items()]]
# posted one after another: with serve batch 4 the batches are the warm-up,
# [1], [3 3 3], [4 4 4 4], [4 4], [0 0], [2]
REQUESTS = ({"label": 1, "count": 1}, {"label": 3, "count": 3}, {"label": "class04", "count": 6},
            {"label": 0, "count": 2}, {"label": 2, "count": 1})
WORKER = os.path.join(REPO, "tests", "torch_serve_worker.py")
SPAWN_TIMEOUT_S = 150  # each group of ranks, start to exit


@pytest.fixture(scope="module")
def weights():
    """(flax params, the port's state_dict of them, the JAX task on a 2-device mesh)."""
    jtask = JaxTask(jc.DDPMConfig(**CFG), create_mesh(MeshSpec(2, 1), devices=jax.devices()[:2]), total_steps=1)
    params = random_flax_variables(jtask.model, jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,)),
                                   jnp.zeros((1,), jnp.int32), jnp.ones((1,)), seed=3)["params"]
    unet = ConditionalUNet(num_classes=CFG["num_classes"], width_mult=CFG["width_mult"], remove_deep_conv=True)
    return params, state_dict_from_flax(unet, {"params": params}), jtask


@pytest.fixture(scope="module")
def workdir(weights, tmp_path_factory):
    """A directory holding the checkpoint ``models/tiny``, where every server runs."""
    d = tmp_path_factory.mktemp("serve_ranks")
    sd = weights[1]
    CheckpointManager(str(d / "models" / RUN["run_name"])).save(1, {"params": sd, "ema_params": sd})
    return d


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _levels(body) -> np.ndarray:
    """A response's PNGs → uint8 levels (n, 16, 16): each viridis colour's
    lowest LUT index (two levels share a colour, one apart)."""
    keys = {tuple(c): i for i, c in reversed(list(enumerate(VIRIDIS_LUT.tolist())))}
    rgbs = [decode_png_rgb(base64.b64decode(b)) for b in body["images"]]
    return np.array([[[keys[tuple(px)] for px in row] for row in rgb.tolist()] for rgb in rgbs], np.int64)


def _serve_requests(base: str, idle_s: float = 0.0) -> dict:
    """The REQUESTS, one after another (an idle pause before the last), then /stats and /healthz."""
    out = {"bodies": []}
    for i, req in enumerate(REQUESTS):
        if i == len(REQUESTS) - 1:
            time.sleep(idle_s)
        status, body = _post(f"{base}/generate", req)
        assert status == 200, (req, status, body)
        out["bodies"].append(body)
    out["stats"] = _get(f"{base}/stats")[1]
    out["health"] = _get(f"{base}/healthz")
    return out


def _one_rank(workdir, serve_batch: int) -> dict:
    """The one-rank server's answers: cli.serve.run in this process."""
    from spectrogramgenai_tpu_torch.cli.serve import run

    cfg = tc.DDPMConfig(**CFG, run=tc.RunConfig(**RUN))
    with contextlib.chdir(workdir):
        server, batcher = run(cfg, port=0, serve_batch=serve_batch, sampler="ddim", num_steps=4, block=False,
                              device="cpu", class_names=[f"class{i:02d}" for i in range(CFG["num_classes"])])
    try:
        return _serve_requests(f"http://127.0.0.1:{server.port}")
    finally:
        server.shutdown()
        batcher.close()


@pytest.fixture(scope="module")
def one_rank_4(workdir):
    return _one_rank(workdir, 4)


class _Ranks:
    """``world`` serve processes with torchrun's environment set by hand;
    each one's output is read by a thread as it comes."""

    def __init__(self, world: int, flags: list[str], cwd, env: dict | None = None):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        base = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "MASTER_ADDR": "localhost",
                "MASTER_PORT": str(port), "WORLD_SIZE": str(world), **(env or {})}
        self.procs = [subprocess.Popen([sys.executable, WORKER, *flags], cwd=cwd,
                                       env={**base, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True) for r in range(world)]
        self.out = [[] for _ in self.procs]
        self.err = [[] for _ in self.procs]
        self._readers = [threading.Thread(target=lambda f=f, lines=lines: lines.extend(f), daemon=True)
                         for p, out, err in zip(self.procs, self.out, self.err)
                         for f, lines in ((p.stdout, out), (p.stderr, err))]
        for t in self._readers:
            t.start()
        self.deadline = time.monotonic() + SPAWN_TIMEOUT_S

    def base_url(self) -> str:
        """Rank 0's address, once it prints that it listens."""
        while time.monotonic() < self.deadline:
            m = re.search(r"listening on ([\d.]+:\d+)", "".join(self.out[0]))
            if m:
                return f"http://{m.group(1)}"
            assert self.procs[0].poll() is None, self.report()
            time.sleep(0.1)
        raise AssertionError(f"rank 0 did not listen within {SPAWN_TIMEOUT_S} s\n{self.report()}")

    def wait(self) -> list[int]:
        """Every process's exit code, each within the group's deadline."""
        try:
            return [p.wait(timeout=max(self.deadline - time.monotonic(), 1)) for p in self.procs]
        finally:
            self.kill()
            for t in self._readers:
                t.join(timeout=10)

    def stop(self) -> list[int]:
        """SIGINT to rank 0, as a user stops the server; then wait for every rank."""
        self.procs[0].send_signal(signal.SIGINT)
        return self.wait()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def rank_lines(self) -> list[dict]:
        lines = []
        for r, out in enumerate(self.out):
            mine = [json.loads(line[len("rank "):]) for line in out if line.startswith("rank {")]
            assert len(mine) == 1 and mine[0]["rank"] == r, self.report()
            lines.append(mine[0])
        return lines

    def report(self) -> str:
        return "\n".join(f"rank {r} rc={p.poll()}\nstdout:\n{''.join(o)}\nstderr:\n{''.join(e)[-3000:]}"
                         for r, (p, o, e) in enumerate(zip(self.procs, self.out, self.err)))


@contextlib.contextmanager
def _ranks(world: int, flags: list[str], cwd, env: dict | None = None):
    ranks = _Ranks(world, flags, cwd, env)
    try:
        yield ranks
    finally:
        ranks.kill()


def _serve_over_ranks(world: int, workdir, extra: list[str], idle_s: float = 0.0,
                      env: dict | None = None) -> dict:
    with _ranks(world, [*FLAGS, *extra], workdir, env) as ranks:
        got = _serve_requests(ranks.base_url(), idle_s=idle_s)
        rcs = ranks.stop()
        assert rcs == [0] * world, ranks.report()
        return {**got, "rank_lines": ranks.rank_lines(), "stdout": "".join(ranks.out[0])}


def _assert_same_images(got: dict, want: dict) -> None:
    """Request by request: the same count, and uint8 levels at most 1 apart
    on at most 1 % of the pixels (a float32 chain whose convolutions sum in
    another order over a split batch; the tp test's tolerance)."""
    for g, w, req in zip(got["bodies"], want["bodies"], REQUESTS):
        assert g["label"] == w["label"] and len(g["images"]) == len(w["images"]) == req["count"]
        diff = np.abs(_levels(g) - _levels(w))
        assert int(diff.max()) <= 1 and float((diff > 0).mean()) <= 0.01, (req, int(diff.max()))
    assert got["stats"]["batches"] == want["stats"]["batches"] == 7  # the warm-up and six
    assert got["stats"]["images"] == want["stats"]["images"]
    assert got["health"] == (200, want["health"][1])


def test_two_ranks_serve_the_one_rank_images_and_outlive_idle_time(workdir, one_rank_4):
    # the control channel's waits last 0.5 s; the server idles 2 s before the last request
    got = _serve_over_ranks(2, workdir, ["--serve_batch", "4"], idle_s=2.0, env={"SERVE_TEST_CONTROL_WAIT_S": "0.5"})
    _assert_same_images(got, one_rank_4)
    front, follower = got["rank_lines"]
    assert front["mesh"] == follower["mesh"] == {"data": 2, "model": 1}
    assert front["backend"] == follower["backend"] == "gloo"
    # the follower ran every batch the front ran, and gathered its rows each time
    assert follower["batches"] == front["batches"] == got["stats"]["batches"]
    assert follower["collectives"]["all_gather"] == front["collectives"]["all_gather"] == got["stats"]["batches"]
    # two waits a batch (the op, the check-in), more while idle
    assert follower["collectives"]["control_wait"] >= 2 * follower["batches"] + 3
    assert "rank 0 of 2 is the front" in got["stdout"]


def test_four_ranks_tensor_parallel_serve_the_one_rank_images(workdir, one_rank_4):
    got = _serve_over_ranks(4, workdir, ["--serve_batch", "4", "--run.mesh_model", "2"])
    _assert_same_images(got, one_rank_4)
    lines = got["rank_lines"]
    assert [(r["data_index"], r["model_index"]) for r in lines] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["mesh"] == {"data": 2, "model": 2} and r["batches"] == got["stats"]["batches"] for r in lines)
    # at width 0.125 the label embedding is the one wide layer: its slices are
    # gathered over the model group in each of a batch's 4 forwards, then the rows
    assert all(r["collectives"]["all_gather"] == (4 + 1) * got["stats"]["batches"] for r in lines)


def test_serve_batch_that_does_not_split_runs_all_labels_on_every_rank(workdir):
    want = _one_rank(workdir, 3)
    got = _serve_over_ranks(2, workdir, ["--serve_batch", "3"])
    for g, w in zip(got["bodies"], want["bodies"]):
        np.testing.assert_array_equal(_levels(g), _levels(w))  # the same computation on each rank
    assert got["stats"]["batches"] == want["stats"]["batches"]
    assert "does not split over the data axis 2" in got["stdout"]
    front, follower = got["rank_lines"]
    assert follower["batches"] == got["stats"]["batches"]
    assert "all_gather" not in front["collectives"] and "all_gather" not in follower["collectives"]


def test_follower_failure_fails_the_batch_and_turns_healthz_503(workdir):
    # rank 1 raises in its second sample call: the first request's batch
    with _ranks(2, [*FLAGS, "--serve_batch", "4"], workdir, env={"SERVE_TEST_FAIL_BATCH": "1"}) as ranks:
        base = ranks.base_url()
        status, body = _post(f"{base}/generate", {"label": 1, "count": 2})
        assert status == 500 and "rank 1: RuntimeError: injected failure in call 1 on rank 1" in body["error"], body
        status, health = _get(f"{base}/healthz")
        assert status == 503 and not health["ok"], health
        assert "rank 1: RuntimeError: injected failure in call 1 on rank 1" in health["device_error"]
        # no rank was left in the rows' gather: the next batch runs on both
        status, body = _post(f"{base}/generate", {"label": 2, "count": 1})
        assert status == 200 and len(body["images"]) == 1
        rcs = ranks.stop()
        assert rcs == [0, 0], ranks.report()
        front, follower = ranks.rank_lines()
        assert follower["batches"] == front["batches"] + 1 == 3  # the failed batch ran on both, counted by rank 1
        assert "injected failure" in "".join(ranks.err[1])


def test_refusals(workdir, monkeypatch):
    from spectrogramgenai_tpu_torch.cli import serve

    # an exported sampler is a one-device program: refused on 2 ranks before anything binds
    with _ranks(2, [*FLAGS, "--artifact", "missing.zip"], workdir) as ranks:
        assert ranks.wait() == [1, 1]
        for r in range(2):
            assert "--artifact serves a one-device program" in "".join(ranks.err[r]), ranks.report()
            assert "listening" not in "".join(ranks.out[r])
    # a mesh of two ranks without torchrun
    for var in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(workdir)
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1: without torchrun there is one rank"):
        serve.main([*FLAGS, "--run.mesh_data", "2"])


def test_two_rank_sample_matches_jax_on_a_two_device_mesh(weights, tmp_path):
    params, sd, jtask = weights
    key = jax.random.PRNGKey(11)
    labels = np.array([0, 1, 2, 4], np.int32)
    want = np.asarray(jtask.sample(types.SimpleNamespace(params=params), key, jnp.asarray(labels),
                                   sampler="dpmpp", num_steps=5))
    x_T = torch.from_numpy(np.array(jax.random.normal(key, (4, 16, 16, 1), jnp.float32)))
    job = dict(kind="sample", name="sample", cfg=CFG, mode="tp", mesh=(2, 1), params=sd,
               sample=(torch.from_numpy(labels).long(), x_T), sampler="dpmpp", num_steps=5)
    ranks = spawn_ranks([job], 2, tmp_path, timeout=SPAWN_TIMEOUT_S)["sample"]
    got = ranks[0]["sample"].numpy()
    assert torch.equal(ranks[1]["sample"], ranks[0]["sample"])
    assert ranks[0]["collectives"] == {"all_gather": 1}  # each rank ran its two labels
    assert got.shape == want.shape == (4, 16, 16, 1) and got.dtype == want.dtype == np.uint8
    assert len(np.unique(want)) > 20  # not a constant image
    # test_slice_matches_jax's tolerance on the uint8 images: at most one level
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
