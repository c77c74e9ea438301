"""Shared helpers of the tests/test_torch_*.py parity tests (not collected)."""

from __future__ import annotations

import os
import re

import jax
import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's torch ops on one thread (import this fixture into it).

    The suite runs in several worker processes at once; torch's default of
    one intra-op thread per core then makes their OpenMP threads spin
    against each other: two CPU training tests took 279 s with eight threads
    and 7.6 s with one, beside six busy processes on eight cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_message(jax_message: str) -> str:
    """A JAX CLI's message as the port prints it: the same text, naming the
    port's weight tools (``tools/port_*.py``) where JAX names its own."""
    return re.sub(r"tools/(provision_eval_weights|convert_torchvision|convert_clap)\.py", r"tools/port_\1.py",
                  jax_message)


def random_flax_variables(module, *init_args, seed: int = 0) -> dict:
    """Random variables for a flax module, as nested dicts of numpy arrays.

    Shapes come from tracing ``module.init`` (no compile); values from a
    numpy seed: kernels normal(0, 1/√fan_in), biases and norm offsets
    normal(0, 0.1) so that every bias mapping of the bridge is exercised,
    norm scales 1 + normal(0, 0.1), embeddings normal(0, 1), a codebook
    uniform(-1/M, 1/M) with ema_weight equal to it, BatchNorm running means
    normal(0, 0.1) and variances uniform(0.5, 1.5).
    """
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)

    def fill(tree, collection):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = fill(leaf, collection)
                continue
            shape = leaf.shape
            if collection == "codebook":
                continue
            if name == "kernel":
                v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
            elif name == "bias":
                v = 0.1 * rng.standard_normal(shape)
            elif name == "scale":
                v = 1.0 + 0.1 * rng.standard_normal(shape)
            elif name == "var":  # BatchNorm's running variance
                v = rng.uniform(0.5, 1.5, shape)
            elif name == "mean":  # BatchNorm's running mean
                v = 0.1 * rng.standard_normal(shape)
            else:
                v = rng.standard_normal(shape)
            out[name] = v.astype(np.float32)
        if collection == "codebook" and "embedding" in tree:
            m, _ = tree["embedding"].shape
            emb = rng.uniform(-1.0 / m, 1.0 / m, tree["embedding"].shape).astype(np.float32)
            out.update(embedding=emb, ema_weight=emb.copy(),
                       ema_count=np.zeros(tree["ema_count"].shape, np.float32))
        return out

    return {col: fill(tree, col) for col, tree in shapes.items()}


# -- multi-rank runs (tests/test_torch_multirank.py, tests/test_torch_tensor_parallel.py) --------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multiprocess_worker.py")

# tests/test_fsdp.py's tiny config: the full-width UNet (leaves of ≥ 2¹⁵
# elements and ≥ 256 output channels) at 16×16 with 8 noise steps, float32
DDPM_CFG = dict(noise_steps=8, img_size=16, num_classes=5, latent=False, lr=2e-3, width_mult=1.0,
                remove_deep_conv=True, compute_dtype="float32", grad_accum=2)
DDPM_BATCH = 8
TOTAL_STEPS = 10
LR0 = DDPM_CFG["lr"] / 25  # the OneCycle schedule's first lr


def spawn_ranks(jobs: list[dict], world: int, tmp_path, timeout: int = 600) -> dict[str, list[dict]]:
    """Run ``jobs`` in ``world`` gloo ranks (``tests/torch_multiprocess_worker.py``,
    one process each, torchrun's environment set by hand); returns each
    job's results by rank."""
    import socket
    import subprocess
    import sys

    import torch

    job_file, out_dir = tmp_path / "jobs.pt", tmp_path / "out"
    out_dir.mkdir()
    torch.save(jobs, job_file)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    base = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(port), "WORLD_SIZE": str(world)}
    procs = [subprocess.Popen([sys.executable, WORKER, str(job_file), str(out_dir)], cwd=REPO,
                              env={**base, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} rc={p.returncode}\nstdout:\n{out}\nstderr:\n{err[-4000:]}"
    return {job["name"]: [torch.load(out_dir / f"{job['name']}.rank{r}.pt", weights_only=False)
                          for r in range(world)] for job in jobs}


def ddpm_inputs(steps: int):
    """(flax params, the port's state_dict of them, the global batches): each
    batch (images, labels, t, noise, keep) with the t, noise and label-keep
    draws of the JAX step from ``PRNGKey(5)`` (its key splits, per microbatch)."""
    import jax.numpy as jnp
    import torch

    from spectrogramgenai_tpu.core import config as jc
    from spectrogramgenai_tpu.core.mesh import MeshSpec, create_mesh
    from spectrogramgenai_tpu.train.diffusion_task import DiffusionTask
    from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax
    from spectrogramgenai_tpu_torch.models.unet import ConditionalUNet

    jt = DiffusionTask(jc.DDPMConfig(**DDPM_CFG), create_mesh(MeshSpec(1, 1), devices=jax.devices()[:1]),
                       total_steps=TOTAL_STEPS)
    params = random_flax_variables(jt.model, jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,)), jnp.zeros((1,), jnp.int32),
                                   jnp.ones((1,)), seed=3)["params"]
    unet = ConditionalUNet(num_classes=DDPM_CFG["num_classes"], remove_deep_conv=True, width_mult=1.0)
    sd = state_dict_from_flax(unet, {"params": params})
    rng, key, k = np.random.default_rng(7), jax.random.PRNGKey(5), DDPM_CFG["grad_accum"]
    n = DDPM_BATCH // k
    batches = []
    for _ in range(steps):
        key, step_key = jax.random.split(key)
        ts, noises, keeps = [], [], []
        for sub in jax.random.split(step_key, k):
            k_t, k_noise, k_drop = jax.random.split(sub, 3)
            ts.append(np.asarray(jax.random.randint(k_t, (n,), 1, DDPM_CFG["noise_steps"])))
            noises.append(np.asarray(jax.random.normal(k_noise, (n, 16, 16, 1), jnp.float32)))
            keeps.append(float(jax.random.uniform(k_drop, ()) >= 0.1))
        images = rng.uniform(0, 1, (DDPM_BATCH, 16, 16, 1)).astype(np.float32)
        labels = rng.integers(0, DDPM_CFG["num_classes"], DDPM_BATCH).astype(np.int32)
        batches.append((torch.from_numpy(images), torch.from_numpy(labels).long(),
                        torch.from_numpy(np.concatenate(ts)), torch.from_numpy(np.concatenate(noises)),
                        torch.tensor(keeps)))
    return params, sd, batches


def jax_ddpm_step(mode: str, data: int, model: int, params, images, labels):
    """One JAX train step on a data × model mesh of the conftest's virtual
    devices under ``mode``, from ``params``: (loss, the port's state_dicts of
    the params after the step and of the step's gradient, from Adam's first
    moment m = (1 − b1)·g)."""
    import jax.numpy as jnp

    from spectrogramgenai_tpu.core import config as jc
    from spectrogramgenai_tpu.core.ema import ema_init
    from spectrogramgenai_tpu.core.mesh import MeshSpec, create_mesh, shard_batch
    from spectrogramgenai_tpu.train import common
    from spectrogramgenai_tpu.train.diffusion_task import DiffusionTask
    from spectrogramgenai_tpu.train.state import new_train_state
    from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax
    from spectrogramgenai_tpu_torch.models.unet import ConditionalUNet

    mesh = create_mesh(MeshSpec(data, model), devices=jax.devices()[:data * model])
    jt = DiffusionTask(jc.DDPMConfig(**DDPM_CFG, run=jc.RunConfig(seed=0, param_sharding=mode)), mesh,
                       total_steps=TOTAL_STEPS)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = common.shard_state(mesh, new_train_state(p, jt.tx, jax.random.PRNGKey(5), ema_params=ema_init(p)),
                               mode=mode)
    batch = shard_batch(mesh, {"image": images.numpy(), "label": labels.numpy().astype(np.int32)})
    state, m = jax.jit(jt._train_step)(state, batch["image"], batch["label"])
    unet = ConditionalUNet(num_classes=DDPM_CFG["num_classes"], remove_deep_conv=True, width_mult=1.0)
    grads = jax.tree_util.tree_map(lambda mu: np.asarray(mu) / 0.1, state.opt_state[0].mu)
    return (float(m["train_mse"]), state_dict_from_flax(unet, {"params": jax.device_get(state.params)}),
            state_dict_from_flax(unet, {"params": grads}))


def assert_grads_close(got: dict, want: dict, rtol: float, floor: float) -> None:
    """Per tensor: ‖got − want‖ ≤ rtol·‖want‖ + floor·(the largest tensor's
    norm). The floor covers tensors whose gradient cancels in exact
    arithmetic (the attention's key biases: softmax is shift-invariant), where
    both sides hold rounding."""
    scale = max(float(w.norm()) for w in want.values())
    for name, w in want.items():
        err = float((got[name] - w).norm())
        assert err <= rtol * float(w.norm()) + floor * scale, (name, err, float(w.norm()), scale)


def assert_step_matches(rank0, one, jax_step):
    """The ranks' first step against the one-rank step (summation order
    only) and the JAX step (the tolerances of tests/test_torch_train.py)."""
    import torch

    # the loss: each rank's mean of its rows, averaged over the data group
    assert abs(rank0["loss"][0] - one["loss"][0]) <= 1e-6 * abs(one["loss"][0])
    # the mean of two ranks' means in float32: measured up to 3.4e-6 of a
    # tensor's norm (the attention's q/k kernels, 5e-4 of the largest
    # tensor's norm); 1e-5 of the tensor plus 1e-8 of the largest norm
    assert_grads_close(rank0["grads"], one["grads"], rtol=1e-5, floor=1e-8)
    # Adam's first update is ≈ lr0·g/(|g| + eps): where |g| stands clear of
    # its rounding the masters agree to 1e-3 of that update plus two float32
    # ulps of the weight (a norm scale near 1 moves by one ulp, 1.2e-7);
    # anywhere to 2·lr0
    for name, g in one["grads"].items():
        p = one["params_step0"][name]
        diff = (rank0["params_step0"][name] - p).abs() - 2.4e-7 * p.abs()
        clear = g.abs() > 1e-3 * g.abs().max()
        assert float(torch.where(clear, diff, 0).max()) <= 1e-3 * LR0 and float(diff.max()) <= 2 * LR0, name
    loss, params, grads = jax_step
    assert abs(rank0["loss"][0] - loss) <= 2e-5 * abs(loss)
    assert_grads_close(rank0["grads"], grads, rtol=1e-4, floor=1e-6)
    for name, want in params.items():
        np.testing.assert_allclose(rank0["params_step0"][name].numpy(), want.numpy(), rtol=1e-4, atol=5e-5,
                                   err_msg=name)
